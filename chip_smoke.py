"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on the card — the commitment planner in both
modes, without and with the spot band and its Monte-Carlo replay, with
the migration and convertible bands on a fleet in generation turnover,
batched over demand scenarios, with telemetry, the breach cadence and
the carried IRLS moments, the fleet simulator with the paper's §4 time
shifting and §5 free pool, the policy tournament, the free-pool
replica autoscaler, the serving engine on
the published stablelm-1.6b, rwkv6-3b, granite-moe-1b-a400m (MoE) and
deepseek-v2-lite-16b (MoE with MLA), internlm2-20b with the int8 KV
cache, qwen2-vl-7b (embedding inputs, M-RoPE), whisper-small (encoder-
decoder) and jamba-v0.1-52b (Mamba, attention and MoE, cut to 16 layers),
and the trainer on the published stablelm-1.6b, granite-moe-1b-a400m and
whisper-small (rwkv6-3b cut to two layers, deepseek-v2-lite-16b to four,
qwen2-vl-7b to eight, jamba-v0.1-52b to one block of two experts), the
EF-int8 compressed train step over a one-rank "pod" mesh, and the shape
cells' dry run on the meta device — and checks each of their kernels (commitment sweep, revocation walk,
generation turnover, flash attention, RWKV6 recurrence, Mamba's selective
scan and its backward) against its plain PyTorch version.  Flash
attention is three CUDA kernels, routed by dtype, head dim and query rows
(``flash_attention.route``): a tensor-core bf16 prefill (``prefill_tc``),
a split-KV decode (``decode_split``) and the SIMT kernel (``simt``: f32
prefill, bf16 with head dim 32); the prefill kernels also take MLA's
value head dim of its own, (Dqk, Dv) = (192, 128) and (96, 64), and the
split decode has an int8 instance that reads the quantized KV cache.
Phases, in this order, each printing one JSON line and raising on
failure:

  device    card name and power limit, torch and CUDA versions
  build     nvcc build of the eight kernel sources, one nvcc each, all at
            once (time, ptxas report)
  kernel    sweep kernel vs plain version on the card: ragged shapes, the
            (T,)/(G,) cases, no weights, prefix masks, the bucketed
            kernel's edges (candidates unsorted, duplicated, all equal,
            descending, equal to some f; zero-weight rows; G = 1; T = 1;
            one row of three years; G = 4096), each also bit for bit
            against the kernel's algebra in plain PyTorch
            (ref.commitment_sweep_bucketed_ref); non-finite rows give NaN;
            the main-path shape 8192 x 128 x 1344, its error against
            float64 no larger than the plain version's; batched launch ==
            one launch per row block, and a rerun == the first run, bit
            for bit
  ties      the solvers' sorts on tied inputs, card vs CPU bit for bit
  turnover  generation-turnover kernel vs its plain version on the card:
            T = 1, ragged T, a fleet with no edges (pure deflation), edges
            at the first and last pool, and the main shape 1024 pools x
            26,280 hours, bit for bit, with volume conserved and a rerun
            bit for bit; the kernel against the per-hour loop
            (migrate_demand_loop) at 1024 x 4,096 hours, bit for bit; the
            kernel's, the plain version's and the loop's times
  fleet     the 1024-pool, 3-year synthetic fleet (seed 0)
  cpu       its first 16 pools replayed on the CPU (plain version, in a
            child process; checked before phase sharded) and on
            the card (kernel): totals, targets, tranche book vs carried
            stack, host syncs of the card replay; the first planner call on
            the card, so the timed plans below find CUDA initialized
  plan      api.plan on the whole fleet with the grid solver: costs (the
            bill within rel 1e-4 of PLAN_BILL), wall time, peak memory,
            sweep launches (the main path)
  quantile  the same fleet with the quantile solver (grid within 2%)
  one_shot  api.plan(PlanRequest(pools=fleet)), the default one-shot plan,
            on the whole fleet (a main path): wall time, peak memory, sweep
            launches (exactly 2: the pools' spend and the aggregate's),
            host syncs (the same count as a 16-pool plan's), the bill
            within rel 1e-4 of ONE_SHOT_BILL, zero widths off each pool's
            cloud; on the first 16 pools the card against the CPU; the
            spend's sweep launch against a launch per row block, bit for
            bit; the batched forecaster fit alone by CUDA events beside
            its bound; optimal_commitment_sweep at 8192 x 1344 against its
            plain version; plan_commitment(solver="golden") on one pool,
            card against the CPU
  spot      the spot band on the same fleet (a main path): api.plan
            rolling with the grid solver and spot=True (sweep launches 234,
            as without spot: the floors come from sorts; its total below
            phase plan's; the bill within rel 1e-4 of SPOT_BILL), the
            one-shot plan with spot=True (2 sweep launches, its bill within
            rel 1e-4 of SPOT_ONE_SHOT_BILL), both modes on the first 16
            pools card vs CPU (the CPU's in a child process, checked
            before phase sharded), and replay_spot_plan of the rolling report
            over 32 revocation draws (one walk launch; availability meets
            its 0.95 target, realized cost within 10% of planned); wall
            times and peak memory
  migration the turnover fleet (1024 pools in 512 old/successor pairs, 128
            regions, 3 clouds, seed 0) synthesized on the card (one
            turnover launch, a main path), then api.plan rolling with the
            grid solver and migration=True, convertible=True (468 sweep
            launches: pool rows and cloud rows each replayed week of both
            replays; the bill within rel 1e-4 of MIGRATION_BILL), the
            one-shot plan with both bands (2 sweep launches, its bill
            within rel 1e-4 of MIGRATION_ONE_SHOT_BILL), and the
            migration-blind rolling grid plan (234) on the same fleet;
            wall times, peak memory, the aware-vs-blind margin (printed);
            both modes on the 16 pools of regions 0 and 1 (whole pairs,
            all three clouds) card vs CPU (the CPU's in a child process,
            checked before phase sharded); the one-shot plan on a fleet
            that buys a convertible band (the planted two-edge table, 1024
            pools x 30 weeks): card vs CPU, the band nonzero, the bill
            within rel 1e-4 of PLANTED_ONE_SHOT_BILL
  profile   the grid plan under torch.profiler: device busy time, time by
            kernel (full table in build/chip_smoke/profile_grid_plan.txt), and
            the host-side tranche book timed alone
  scenarios scenario batching (a main path): each perturbation's rows
            built on the card against the numpy rows, bit for bit (growth
            on every pool); the fleet-scale batch of the repo's benchmark
            (N = 32 growth futures, quantile solver, cadence 1, start 26,
            horizon 8, no baselines) with scenario 0 bit for bit equal to
            the unbatched replay; api.plan rolling with the grid solver and
            ScenarioConfig(32, "regime") at phase plan's settings: exactly
            234 sweep launches (the scenarios ride the row axis), scenario
            0 bit for bit equal to phase plan's report (per-week arrays,
            weekly costs, its bills), wall time, peak memory, device busy
            under the profiler; an N = 8 spot plan (scenario 0 equal to
            phase spot's report) and replay_spot_plan(scenario=3) over 32
            draws meeting 0.95 (one walk launch); an N = 4 aware plan on
            the turnover fleet (468 launches, scenario 0 equal to phase
            migration's report); on 16 pools over the fleet's first 39
            weeks (start 26), N = 4 chunked by 3, equal to the unchunked
            run bit for bit and to the CPU within rel 1e-4 of each
            scenario's bill and one grid cell
  telemetry the main fleet at phase plan's settings (a main path, 234
            sweep launches per plan): the plain plan again (wall time,
            host syncs); api.plan with TelemetryConfig(calibration=True,
            provenance=True), every per-week array and bill bit for bit
            with phase plan's report, its ledger reconciled with the
            weekly costs, its kernel stats the shape of every recorded
            sweep launch, the calibration coverage per fractile, the
            decision log's holdings against the carried stack at three
            weeks, and its wall time beside the plain plan's; the breach
            cadence (decision weeks against the weekly 117, the bill
            against the weekly bill and within rel 1e-4 of BREACH_BILL,
            the mask bit for bit with a host loop over the emitted bands,
            host syncs no more than the weekly plan's); irls_iters=1 with
            irls_carry=True within rel 2e-3 of the exact irls_iters=1 plan
            and closer to it than irls_iters=0; 32 regime futures under
            the breach cadence with calibration (per-scenario masks, one
            cube, scenario 0 bit for bit with the breach plan, wall time,
            peak memory); breach, calibration, provenance and carry
            together on 16 pools, card vs CPU (masks equal, the bill
            within rel 1e-4); run_tournament with a SpanRecorder timed by
            CUDA events, a span per policy
  fleet_sim the fleet simulator on the default fleet (ten architectures'
            serving fleets, three training jobs, 12 pools): chips per
            replica from the parameter counts; simulate_and_plan_pools()
            (2 sweep launches), simulate_and_replan_pools() with the
            default and the grid solver (2 sweep launches per replayed
            week), with demand_migration=True (1 turnover launch) and with
            spot=True, replayed by replay_spot_plan (1 walk launch);
            plan_fleet and plan_fleet_portfolio with shiftable_frac=0.3;
            the paper's §4 rows on 52 weeks (unused commitment, weekend
            trough share, time-shift saving, shift_demand's conservation)
            and Fig. 12 (static vs predicted free pool); every plan card
            vs CPU on the same traces within rel 1e-4, the bills within
            rel 1e-4 of FLEET_BILL
  tournament  run_tournament at the reference's defaults (every policy, 5
            families x 32 seeds x 3 pools x 48 weeks) on the card, against
            the CPU on the same paths (rel 1e-4 of each path's bill) and
            the loop backend (rel 1e-3)
  sharded   the multi-rank pieces on two rank processes that share the one
            card (cuda:0 each, a gloo group over a file rendezvous; the
            parent's cached memory freed first): api.plan with the grid
            solver and ScenarioConfig(32, "regime") at phase scenarios'
            settings, each rank replaying 16 futures (234 sweep launches a
            rank) and ending with phase scenarios' report bit for bit
            (every array and scalar of it, read from a file); the
            tournament at its defaults, its costs and hindsight optima bit
            for bit with phase tournament's; an elastic round trip of
            stablelm-1.6b's params and AdamW state at full width cut to 2
            layers (SHARDED_LAYERS), drawn from a seeded generator: saved
            by the parent at world 1 and restored onto {"data": 2} under
            TRAIN_RULES, every local shard its slice of the full tensor
            bit for bit, each rank's parameter and optimizer bytes equal
            to the dry run's per-device count for that mesh; then placed
            and saved by the ranks and restored by the parent at world 1,
            bit for bit.  Each rank's wall seconds and peak memory, the
            exchange's seconds and bytes, the sweep launches a rank; the
            two ranks time-share one card, so no time is a multi-card one
  autoscaler  the free-pool autoscaler (serve/autoscaler.py) on the
            reference's demand (21 days of hourly history, 2 days held
            out, base 20, 20% annual growth, seed 0): plan on the card and
            on the CPU, the targets within 1e-4 of the plan's peak (the
            free pool's tolerance), the tick-by-tick bookkeeping equal up
            to the first target within that tolerance of an integer, and
            the predicted pool beating the static median pool on SLO
            misses and the static 1.2 x max pool on replica-ticks
  flash     flash-attention kernels vs plain version: ragged shapes in
            f32 and bf16 and both layouts (each case checked to launch the
            kernel its route names; among them simt's tile seams: Sq and
            Skv of 65, 127, 200, kv_len below Skv, GQA group 4, D 32, 64
            and 128), prefill (1, 32, 2048, 64) causal in
            bf16 and f32, and a batched decode (8 slots, 32 heads, one
            query) against a 4096-long cache with 8 different kv_len, in
            bf16 and f32, held also against the split-KV algebra's plain
            version; MLA's head dims (192, 128) and (96, 64), ragged, one
            query, a wrapped ring, in f32 (simt) and bf16 (prefill_tc),
            and the bf16 prefills (1, 2048, 16, 192/128) and (1, 2048,
            40, 96/64) causal (FLASH_MLA), and serve_int8's longest
            prefill (1, 2048, 48/8, 128) causal in bf16
            (FLASH_INTERNLM2_PREFILL); the vlm, audio and hybrid
            families' shapes (FLASH_FAMILIES, bf16): whisper's encoder
            (1, 1500, 12, 64) non-causal, its cross-attention (1, 224 ->
            1500, 12, 64) non-causal and its cross decode (8 slots over
            1500 frames, kv_len 1500), its decoder's self-attention
            prefill (1, 224, 12, 64) causal and decode (8 slots, cache
            448, ragged fill levels up to 448), qwen2-vl's prefill (1,
            2048, 28/4, 128) and jamba's (1, 2048, 32/8, 128) causal and
            their decodes (8 slots, D 128, cache 4096, ragged fill
            levels), and the three families' train steps' shapes
            (FLASH_FAMILIES_TRAIN, bf16): whisper-small's encoder (16,
            1500, 12, 64) and cross-attention (16, 448 -> 1500, 12, 64)
            non-causal and its decoder's self-attention (16, 448, 12,
            64) causal, qwen2-vl's (4, 2048, 28/4, 128) and jamba's (4,
            2048, 32/8, 128) causal, each on the kernel its route
            names; each bf16
            query row's error
            norm against its reference norm as well as element by element;
            decode_split's int8 instance (FLASH_INT8_*: 8 slots with 8
            ragged kv_len, GQA groups 1, 4 and 6, D 32, 64 and 128, q in
            bf16 and f32, an all-zero cache row at the scale floor, values
            at +-127) and at serve_int8's own decode (8 slots, 48/8 heads,
            D 128, a 4096-long cache, 16 splits), bit for bit against the
            bf16/f32 instance on the same cache dequantized by torch, and
            against the plain version within the dtype's tolerance (the
            timed int8 inputs held so again in phase timing); a 3-query
            decode over the int8
            cache dequantized first, on the prefill kernels
  linrec    RWKV6 kernels (chunk, state scan, inter: one call) vs plain
            version: ragged T, strong decay, a carried state, the model's
            whole decay range, a chunk whose decay is exactly 0, B = 2 at
            T = 2048, and (1, 40, 2048, 64), where the states entering the
            chunks (the scan's scratch) are also held against the
            chunk-parallel plain version
  mamba     the Mamba scan kernels (chunked, three passes each) vs their
            plain step loops on the card: the forward at jamba's d_inner
            8192 and state 16 at S = 1, 13, 64 and 2048, and state 8 at a
            ragged (2, 37, 256), y and the final h within 1e-5 of their
            largest; the backward from the forward's chunk-start states at
            (1, 64, 8192, 16), (2, 13, 256, 8) and (1, 2048, 8192, 16),
            with and without the final state's gradient, each gradient
            within 1e-5 of its largest against the reverse-time loop; one
            launch a call, reruns bit for bit, the trainable op's
            gradients bit for bit with the backward kernel's
  walk      revocation-walk kernel vs its plain per-hour loop on the card:
            T = 1, ragged T and lanes, all-available and all-revoked
            starts, hazard 0 with recovery 1, and the main shape (32 draws
            x 1024 pools x 117 weeks of hours); states and interruptions
            bit for bit, prices within 1e-6, a rerun bit for bit
  model_cpu the reduced float32 stablelm-1.6b, rwkv6-3b,
            granite-moe-1b-a400m, deepseek-v2-lite-16b and minicpm3-4b
            (the MLA two at minicpm3's head dims, MLA_CARD_DIMS), and
            qwen2-vl-7b, whisper-small and jamba-v0.1-52b (the first two
            through ApplyEngine, jamba's scans on the kernel at state 8)
            served on the CPU (plain versions) and on the card (kernels):
            tokens equal, logits close; flash decode on decode_split, f32
            prefill on simt (MLA's at (96, 64)), no flash launch in MLA's
            decode; the MoE layer alone at capacity factor 1.0 over 512 tokens,
            dropped counts equal, outputs within 1e-5 of the largest
  serve_dense  the full published stablelm-1.6b in bf16, random weights
            from a seeded generator on the card: an engine of 8 slots and
            cache 4096 serves 16 requests (prompts of 128-2048 tokens, 32
            new tokens each); throughput, time to first token, flash
            launches by kernel (exactly 24 x 16 prefill_tc, 24 x ticks
            decode_split, no simt), peak memory (a main path)
  serve_rwkv   the same for the full rwkv6-3b; RWKV6 launches (a main path)
  serve_moe    the same for the full granite-moe-1b-a400m (GQA, MoE in
            every layer): 24 x 16 prefill_tc, 24 x ticks decode_split, the
            decode tick's expert products against the bytes of every
            expert's weights (a main path)
  serve_mla    the same for the full deepseek-v2-lite-16b (MLA, a dense
            first layer, MoE with shared experts): 27 x 16 prefill_tc at
            (192, 128), no decode_split (the absorbed decode), the tick's
            expert products and absorbed decode by profiler range (a
            main path); every serve phase's flash launches by kernel are
            expected_flash_mix's, exactly, and its int8 decode launches 0
  serve_int8   the full internlm2-20b (48 layers, d 6144, GQA 48/8 at D
            128) with kv_cache_dtype="int8" (a main path): 48 x 16
            prefill_tc at (128, 128), 48 x ticks decode_split, every one
            of them the int8 instance; the int8 cache under 0.6 of the
            bf16 cache's bytes; on two requests the first decode tick's
            logits within the reference's bound (0.05 max|logits| + 0.1,
            tests/test_perf_knobs.py) of the same weights with a bf16
            cache
  serve_vlm    the full qwen2-vl-7b (28 layers, d 3584, GQA 28/4 at D
            128, M-RoPE) on serve_dense's 16 prompts as (S, 3584)
            embeddings drawn on the card; the engine refuses the family
            (it feeds tokens), so ApplyEngine runs the engine's steps on
            Model.apply, each sampled token's next input a row of a seeded
            stand-in text table made here: exactly 28 x 16 prefill_tc and
            28 x ticks decode_split, the first token equal to a direct
            prefill's (a main path)
  serve_audio  the full whisper-small (12 + 12 layers, d 768, 12 heads at
            D 64) through ApplyEngine: 16 clips of 1500 frames (30 s each)
            with decoder prompts of 4-224 tokens, cache 448: exactly 36
            prefill_tc a prefill (12 encoder layers non-causal over 1500
            frames, 12 self, 12 cross) and 24 decode_split a tick (12
            self, 12 cross over the cached 1500 frames) (a main path)
  serve_hybrid jamba-v0.1-52b at full width cut to two period-8 blocks (16
            layers: 14 Mamba, 2 attention, 8 MoE of 16 experts top-2;
            26.05e9 parameters, 52.1 GB; all 32 layers do not fit one
            card) through the engine on serve_dense's requests: exactly
            2 x 16 prefill_tc, 2 x ticks decode_split and 14 x 16 Mamba
            scans, the scan's device ms in the longest prefill (a main
            path); each of the three reports what serve_dense does
  train     training (a main path): flash_attention_trainable's output and
            dq, dk, dv against autograd through the plain version on the
            card (S 65 and 200, GQA groups 1 and 4, head dims 32-128, f32
            and bf16, and the main (4, 2048, 32, 64) bf16), the same for
            rwkv6_trainable (ragged T, a carried state, (1, 40, 2048, 64)
            and the train path's (4, 40, 2048, 64): y and the state
            against the chunked version, the gradients of r, k, v, logw,
            u and the state against the step loop and the chunked form
            at chunks of 16, algebras the op's backward does not run);
            the reduced float32 stablelm-1.6b and rwkv6-3b 3 train steps
            on the card and on the CPU (losses rel 1e-5, parameters as
            TRAIN_CPU_TOL says, a CPU run at 1% more learning rate as the
            control the update gate must catch); Trainer.fit on the full
            stablelm-1.6b in bf16 (12 steps of 4 x 2048 tokens, AdamW lr
            3e-4 warmup 5, remat "full"): step 1 twice bit for bit, the
            losses finite and descending, exactly 2 x 24 prefill_tc
            launches per step (forward and recompute), no simt or
            decode_split, step seconds (median of steps 3-12), tokens/s,
            peak memory, one step under torch.profiler (device busy, time
            by kernel, the flash backward's and the embedding gradient's
            shares) and the embedding gradient's sorted sum against the
            gather's atomics; crash at step 6 and restart from the step-4
            checkpoint at full width with 2 layers, the losses of steps
            5-8 equal to an uninterrupted run's bit for bit, the save's
            seconds and bytes; rwkv6-3b at full width with 2 layers, 3
            steps, 2 RWKV6 launches per layer and step.  The trainable
            flash op also at MLA's (192, 128) and (96, 64) (f32 on simt,
            bf16 on prefill_tc, S 65 and 200, groups 1 and 4, and
            deepseek's (4, 2048, 16, 192/128) bf16), and the reduced f32
            granite-moe-1b-a400m, deepseek-v2-lite-16b and minicpm3-4b
            (MLA at MLA_CARD_DIMS) card vs CPU as above
  train_moe Trainer.fit as phase train's main path (bf16, 12 steps of 4 x
            2048 tokens, AdamW lr 3e-4 warmup 5, remat "full") on the full
            granite-moe-1b-a400m (24 layers, 32 experts top-8) and on
            deepseek-v2-lite-16b at full width cut to 4 layers (the dense
            first layer and 3 MoE layers; the whole model's bf16 weights,
            gradients and float32 AdamW state would not fit one card):
            step 1 twice bit for bit, losses finite and descending,
            exactly 2 x layers prefill_tc launches a step (at (64, 64) and
            (192, 128)), no simt or decode_split; step seconds, tokens/s,
            peak memory, one step under torch.profiler (device busy, the
            flash backward's, the expert products' and the MoE combine
            backward's shares) (a main path)
  train_families  the reduced f32 qwen2-vl, whisper and jamba card vs CPU
            (as phase train); then Trainer.fit (bf16, 12 steps, remat
            "full") on whisper-small whole (16 x 448 decoder tokens over
            1500 frames a row), qwen2-vl-7b at full width cut to 8 layers
            (4 x 2048 embeddings, rows of a seeded stand-in table) and
            jamba-v0.1-52b as one period-8 block with 2 experts at every
            published width (4 x 2048 tokens), the cuts under "reduced":
            step 1 twice bit for bit, losses finite and descending,
            exactly the step's launches (prefill_tc for every attention,
            causal and non-causal, forward and recompute; jamba's 14 scan
            forwards and 7 scan backwards), step seconds, tokens/s, peak
            memory, one step profiled (the non-causal flash backward's and
            the scan backward's shares) (a main path)
  train_compressed  phase train's main path (the full stablelm-1.6b,
            bf16, 4 x 2048 tokens, AdamW lr 3e-4 warmup 5) as the EF-int8
            compressed step (train/step.py build_compressed_train_step)
            over a one-rank NCCL process group and make_pod_mesh(1), 4
            steps from the plain step's init and batches: exactly 48
            prefill_tc a step as the plain step, step 1's loss equal to
            the plain step's bit for bit, every leaf after the first sync
            within half its shared scale (plus an ulp of g's dtype) of g
            and g + e_old = g_avg + e_new within rounding, finite losses,
            a rerun bit for bit; step seconds beside the plain step's,
            the sync's device ms (profiler range ef_int8_sync), the error
            state's bytes, peak memory; under that NCCL group, the
            multi-rank pieces' host route: launch.mesh.host_group made once
            and kept, gather_rows, and a placed bfloat16 leaf saved over
            the host group and restored onto its mesh, bit for bit
  cells     the dry run (launch/dryrun.py) of all 32 shape cells under
            both production mesh shapes on the meta device: per-device
            bytes, fit against this card's memory, roofline terms; the
            meta-device byte count of phase train's build (stablelm-1.6b
            and its AdamW state), serve_int8's (internlm2-20b and its int8
            cache, 8 x 4096) and serve_hybrid's (jamba at 16 layers and
            its cache) against the card's allocations (requested bytes
            exactly, allocated within 512 bytes a tensor) and the dry
            run's own count of them; model FLOPs a step of phase train's
            and train_families' runs and their share of the bf16 peak
            beside their step seconds (readings)
  timing    each kernel's and its plain version's times at its main-path
            shape (the sweep also at the scenario plan's 262,144 x 128 x
            1,344; flash: prefill_tc at the bf16 prefill and MLA's two
            prefill shapes (with the backend SDPA took there) and the MoE
            train shapes (4, 2048, 16, 64) and (4, 2048, 16, 192/128),
            serve_int8's prefill (1, 2048, 48/8, 128) beside SDPA, the
            FLASH_FAMILIES and FLASH_FAMILIES_TRAIN shapes beside SDPA
            and its backend,
            decode_split at the bf16 decode and, int8 instance beside the
            bf16 one, at internlm2-20b's (8, 4096, 8, 128) cache (no
            library call reads int8: SDPA over the bf16 cache for
            context), simt at the f32 prefill, and
            at head dim 128 beside the library; RWKV6 also at a short prompt's T = 128;
            the Mamba scan at jamba's longest prefill (1, 2048, 8192, 16)
            beside its plain loop and its bound, and summed over serve_hybrid's prompts and
            Mamba layers; at jamba's train step (4, 2048, 8192, 16) the
            forward, and the backward beside its plain loop and bound;
            the revocation walk at its main shape; the turnover kernel's
            from phase turnover),
            library times,
            bounds, each flash wrapper's and library call's host time per
            call, then the kernel line {"kernels": [...]}

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 before any
phase.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Main-path shape of the sweep: 1024 pools x 8 horizon prefixes rows,
# 8 weeks of hours, num_grid candidates.
NUM_POOLS, NUM_HOURS, HORIZON_WEEKS, NUM_GRID = 1024, 24 * 365 * 3, 8, 128
MAIN_P, MAIN_T, MAIN_G = NUM_POOLS * HORIZON_WEEKS, HORIZON_WEEKS * 168, NUM_GRID
EXPECTED_LAUNCHES = 234     # 117 replayed weeks x (rolling + one-shot)
RTOL, ATOL, COST_RTOL = 2e-4, 1e-2, 1e-5
# The grid plan's bill on that fleet as this script has printed it since
# the planner's first port; a sweep change must keep it within BILL_RTOL.
PLAN_BILL = {"total_cost": 4317372416.0, "one_shot_cost": 5832199168.0,
             "hindsight_cost": 5018841088.0}
BILL_RTOL = 1e-4
# The one-shot plan: its sweep launches (the pools' spend, P rows, and the
# aggregate's, one row), and its bill on that fleet as this script first
# printed it: the pools' total, its committed part and the aggregate
# plan's total.
EXPECTED_ONE_SHOT_LAUNCHES = 2
ONE_SHOT_BILL = {"total_cost": 452913383.2636407,
                 "committed_cost": 402241631.9006088,
                 "aggregate_cost": 439929577.2340426}
ONE_SHOT_COSTS = ("total_cost", "committed_cost", "on_demand_cost",
                  "aggregate_cost", "pooling_premium", "savings_vs_on_demand")
CARD_CPU_RTOL = 1e-4     # one-shot costs card vs CPU, of the bill
# The CPU references of the 16-pool card-vs-CPU checks of phases cpu, spot
# and migration run in child processes (`chip_smoke.py --cpu-ref NAME DIR`,
# no card) while the card runs the phases after them, each on this many
# threads; the checks are made before phase sharded.
CPU_REF_THREADS = 2
CPU_REF_TIMEOUT = 600       # seconds a check waits for its reference
# The spot band on that fleet: the rolling grid plan's and the one-shot
# plan's bills with spot=True as this script first printed them.
SPOT_BILL = {"total_cost": 3942802368.0, "one_shot_cost": 5440932352.0,
             "hindsight_cost": 5018841088.0, "spot_cost": 765553088.0}
SPOT_ONE_SHOT_BILL = {"total_cost": 417067461.5701953,
                      "committed_cost": 324499680.31017286,
                      "spot_cost": 83008230.7904413,
                      "aggregate_cost": 411927335.9105216}
SPOT_TARGET = 0.95           # SpotConfig().availability_target
SPOT_REPLAY_DRAWS = 32
SPOT_REALIZED_RTOL = 0.10    # realized vs planned cost of the replay
EXPECTED_WALK_LAUNCHES = 1   # one walk per replay
# The revocation walk's main shape: the replay's draws x pools x hours
# (the 117 replayed weeks of the grid plan); prices within WALK_PRICE_TOL
# of the plain version, states bit for bit.
WALK_MAIN = (SPOT_REPLAY_DRAWS, NUM_POOLS, 117 * 168)
WALK_PRICE_TOL = 1e-6
# operations per lane-hour: 3 compares, a select, a sub, 3 muls, 2 adds,
# the clip's max and min
WALK_OPS = 12
STACK_TOL = dict(rtol=0.03, atol=0.05)  # widths and levels, card vs CPU
SWEEP_COST_BOUND = 1e-3     # grid+refine: C(c) <= C(c_exact) (1 + bound)
PLAIN_CHUNK = 512           # rows per plain-version chunk at the main shape
# Generation turnover: the kernel's main shape is the turnover fleet's
# (P, T); the per-hour loop oracle runs on its first TURNOVER_LOOP_HOURS.
# Float32 operations, counting an expf as one: per (edge, hour) t - mid,
# the rate's product, the sigmoid's expf, add and divide, the move's
# product, the source's sub, the gain's product, the successor's add and
# the two outputs' deflator products; per lone (pool, hour) the deflator's
# product; per hour the deflator's product and expf.
TURNOVER_LOOP_HOURS = 4096
TURNOVER_PAIR_OPS = 11
TURNOVER_HOUR_OPS = 2
TURNOVER_VOLUME_RTOL = 1e-4   # perf-adjusted volume, the reference's bound
# The migration and convertible bands on the turnover fleet: sweep launches
# of the aware rolling grid plan (pool rows and cloud rows, each replayed
# week of the rolling and the one-shot replay), of the blind one, and the
# bills as this script first printed them.
EXPECTED_MIGRATION_LAUNCHES = 468
EXPECTED_TURNOVER_LAUNCHES = 1   # the fleet's synthesis
MIGRATION_BILL = {"total_cost": 2187169220.0, "one_shot_cost": 2926051328.0,
                  "hindsight_cost": 2391582720.0,
                  "convertible_cost": 9718212.0}
MIGRATION_ONE_SHOT_BILL = {"total_cost": 131127077.20286283,
                           "committed_cost": 117252783.51498042,
                           "aggregate_cost": 126406127.60638298}
MIGRATION_REGIONS = ("region_0", "region_1")   # the card-vs-CPU subset
# The one-shot convertible band where it is nonzero: the full-width fleet
# over 30 weeks with the reference's planted two-edge table (its
# tests/test_generations.py fixture: aws C6i -> C7i from week 8 over 12
# weeks, gcp N2 -> N4 from week 16 over 10), a 4-week horizon; the bill as
# this script first printed it.
PLANTED_GENERATIONS = (("aws", "C6i", "C7i", 8, 12.0, 0.25),
                       ("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50))
PLANTED_WEEKS, PLANTED_HORIZON_WEEKS = 30, 4
PLANTED_ONE_SHOT_BILL = {"total_cost": 31999601.274787903,
                         "conv_cost": 246545.78058510643}
# Scenario batching (scenarios=): N futures flattened into the replay's
# rows.  The fleet-scale setting of benchmarks/paper_benches.py
# (bench_fleet_scale: N = 32 growth futures, cadence 1, start 26, horizon
# 8, the quantile solver, no baselines); the grid plan at phase plan's
# settings with N = 32 regime futures (its sweep launches unchanged, the
# scenarios ride the row axis); an N = 8 spot plan and the replay of one
# of its scenarios; an N = 4 aware plan on the turnover fleet (468
# launches, as without scenarios); and N = 4 with chunk 3 on 16 pools.
SCEN_N = 32
SCEN_FLEET_KW = dict(cadence_weeks=1, start_weeks=26, horizon_weeks=8,
                     compare=False)
SCEN_SPOT_N, SCEN_SPOT_REPLAYED = 8, 3
SCEN_AWARE_N = 4
# N = 4 chunked by 3 on 16 pools over the fleet's first 39 weeks, start
# 26 (the CPU's plain sweep over 64 rows and three years took minutes)
SCEN_CHUNK_N, SCEN_CHUNK, SCEN_CHUNK_POOLS = 4, 3, 16
SCEN_CHUNK_WEEKS, SCEN_CHUNK_START = 39, 26
# scenarios whose rows of each perturbation are held against the numpy
# rows on the host, and the pools sampled (growth: every pool)
SCEN_CHECKED = (1, SCEN_N - 1)
SCEN_SAMPLED_POOLS = (0, 1, 511, NUM_POOLS - 1)
# The tournament at the reference's defaults (5 policies x 5 families x 32
# seeds x 3 pools x 48 weeks; start 20, cadence 2, horizon 8): each path's
# bill card against CPU within rel 1e-4; the scan backend against the loop
# backend within the replay parity's bill tolerance, rel 1e-3 (the loop's
# direct refit differs from the prefix-sum refit by ~1e-4 in the forecasts,
# ROADMAP Queue 3; a CPU run at this size puts paths 1.07e-4 apart).
TOURNAMENT_RTOL = 1e-4
TOURNAMENT_LOOP_RTOL = 1e-3
# phase sharded: two rank processes on the one card
SHARDED_WORLD = 2
SHARDED_MESH = {"data": SHARDED_WORLD}
SHARDED_ARCH = "stablelm-1.6b"
SHARDED_LAYERS = 2          # the elastic round trip's depth, at full width
SHARDED_SEED = 11
SHARDED_TIMEOUT = 400       # seconds for both ranks
# Telemetry, the breach cadence and the carried IRLS moments on the main
# fleet at phase plan's settings (grid solver, 234 sweep launches each):
# the breach plan's bill as this script first printed it (within
# BILL_RTOL from then on); the carried plan within CARRY_RTOL of the
# exact irls_iters=1 plan, and closer to it than irls_iters=0 (the
# reference's tests/test_api.py::TestIrlsCarry); N = 32 regime futures
# under the breach cadence with calibration; 16 pools card vs CPU.
BREACH_BILL = {"total_cost": 4317372928.0, "one_shot_cost": 5832199168.0,
               "hindsight_cost": 5018841088.0}
CARRY_RTOL = 2e-3
TELEMETRY_SCEN_N = 32
PROVENANCE_WEEKS = (0, 58, 116)      # evaluated weeks whose stack is rebuilt
# The fleet simulator on the default fleet (the ten registry architectures'
# serving fleets and three training jobs over 12 pools): chips per replica
# from the parameter counts; the bills of simulate_and_replan_pools() (the
# default quantile solver, solver="grid", demand_migration=True and
# spot=True) and simulate_and_plan_pools() as this script first printed
# them (within BILL_RTOL from then on); each plan card against the CPU on
# the same traces within FLEET_CPU_RTOL (its committed and on-demand parts
# as a share of its bill, as phase one_shot holds them).
FLEET_CHIPS = {
    "deepseek-v2-lite-16b": 3, "granite-moe-1b-a400m": 1,
    "internlm2-20b": 4, "jamba-v0.1-52b": 9, "minicpm3-4b": 1,
    "phi3-medium-14b": 3, "qwen2-vl-7b": 2, "rwkv6-3b": 1,
    "stablelm-1.6b": 1, "whisper-small": 1}
FLEET_BILL = {
    "one_shot": {"total_cost": 238433.9967525035,
                 "aggregate_cost": 224332.10542719412},
    "replan": {"total_cost": 1273188.125, "one_shot_cost": 1373428.5,
               "hindsight_cost": 1267282.625},
    "replan_grid": {"total_cost": 1258303.75, "one_shot_cost": 1372896.875,
                    "hindsight_cost": 1267282.625},
    "replan_migration": {"total_cost": 1173464.125,
                         "one_shot_cost": 1229900.0,
                         "hindsight_cost": 1159077.5},
    "replan_spot": {"total_cost": 1123645.0625, "one_shot_cost": 1279382.25,
                    "hindsight_cost": 1267282.625},
}
FLEET_CPU_RTOL = 1e-4
FLEET_ONE_SHOT_LAUNCHES = 2       # the spend's sweep: pools and aggregate
FLEET_SHIFT_RTOL = 1e-6           # shift_demand's conservation of work
# Paper rows (benchmarks/paper_benches.py): §4 on 52 weeks with 52 jobs of
# 5% of the work, Fig. 12 on 8 weeks of history and the ninth held out.
SEC4_WEEKS, SEC4_JOBS, SEC4_SEED = 52, 52, 4
FIG12_WEEKS, FIG12_SEED = 8, 5
# Peak rates for the bound (NVIDIA data sheets, dense, at the full power
# limit): FP32 on the CUDA cores, bf16 on the tensor cores, HBM bandwidth
# (and the link's, for the dry run's collective term), by H100 variant.
from repro_torch.launch.roofline import PEAKS  # noqa: E402
# Serving: the engine and its requests (prompt lengths from numpy seed 0)
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS = 8, 4096, 16
PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 128, 2048, 32
PROFILE_TICKS = 8           # decode ticks under the profiler, every slot busy
# Kernel main shapes: flash prefill (B, H, S, D) and decode (slots, H, D)
# against SERVE_CACHE; linrec (B, H, T, d)
FLASH_PREFILL = (1, 32, 2048, 64)
FLASH_DECODE = (SERVE_SLOTS, 32, 64)
LINREC_MAIN = (1, 40, 2048, 64)
LINREC_SHORT = (1, 40, 128, 64)     # a short prompt's call, timed beside it
FLASH_F32 = dict(atol=2e-5, rtol=1e-4)
# bf16: element by element (P is rounded to bf16 for the tensor cores, so
# in a row over a few keys whose output cancels the error is ~2^-9 of |v|,
# not of |out|), and each query row's error norm at most `row` times the
# row's reference norm, which holds a whole row to ~1/50 of its size
FLASH_BF16 = dict(atol=1e-2, rtol=1e-2, row=2e-2)
# MLA's prefill shapes (B, H, S, Dqk, Dv): deepseek-v2-lite's and
# minicpm3's head dims at a 2048-token prompt
FLASH_MLA = {"mla_192_128": (1, 16, 2048, 192, 128),
             "mla_96_64": (1, 40, 2048, 96, 64)}
# the MoE family's train steps' attention (B, H, S, Dqk, Dv): granite-moe's
# and deepseek-v2-lite's at TRAIN_BATCH x TRAIN_SEQ (phase train_moe)
FLASH_MOE_TRAIN = {"train_granite_64_64": (4, 16, 2048, 64, 64),
                   "train_deepseek_192_128": (4, 16, 2048, 192, 128)}
# decode_split's int8 instance: 8 slots with ragged fill levels over a
# cache of FLASH_INT8_CACHE, two kv heads in GQA groups 1, 4 and 6 at head
# dims 32, 64 and 128; the timed shape is internlm2-20b's (slots, q heads,
# kv heads, D) against SERVE_CACHE
FLASH_INT8_CACHE = 1024
FLASH_INT8_LENS = (1, 77, 256, 257, 600, 999, 1000, 1024)
FLASH_INT8_CASES = tuple((g, d) for g in (1, 4, 6) for d in (32, 64, 128))
FLASH_INT8_DECODE = (SERVE_SLOTS, 48, 8, 128)
# prefill_tc on serve_int8's path: internlm2-20b's longest prompt,
# (B, Hq, Hkv, S, D)
FLASH_INTERNLM2_PREFILL = (1, 48, 8, PROMPT_MAX, 128)
# the flash kernels' names as the profiler shows them (all hold "flash_"),
# by route
FLASH_PROFILE_NAMES = {
    "prefill_tc": ("flash_prefill_tc_kernel",),
    "decode_split": ("flash_decode_split_kernel",
                     "flash_decode_combine_kernel"),
    "simt": ("flash_simt_kernel",)}
# the port's torch.profiler.record_function ranges (the trainable flash
# op's backward, the embedding's backward, the MoE's expert products, MLA's
# absorbed decode, the MoE combine's backward)
ANNOTATIONS = ("flash_attention_backward", "embed_backward", "moe_experts",
               "mla_absorbed_decode", "moe_combine_backward",
               "flash_attention_backward_noncausal", "mamba_scan_backward",
               "ef_int8_sync")
SERVE_RANGES = ("moe_experts", "mla_absorbed_decode")
# the three kernels of one RWKV6 call (all hold "rwkv6_")
RWKV6_PROFILE_NAMES = ("rwkv6_chunk_kernel", "rwkv6_state_scan_kernel",
                       "rwkv6_inter_kernel")
LINREC_TOL = dict(atol=2e-3, rtol=2e-3)
# card vs CPU logits of the reduced float32 models (the tolerances of the
# CPU parity tests against the JAX package)
MODEL_TOL = {"stablelm-1.6b": 1e-4, "rwkv6-3b": 2e-3,
             "granite-moe-1b-a400m": 1e-4, "deepseek-v2-lite-16b": 1e-4,
             "minicpm3-4b": 1e-4, "qwen2-vl-7b": 1e-4, "whisper-small": 1e-4,
             "jamba-v0.1-52b": 1e-4}
# phase model_cpu gives the reduced MLA configs minicpm3's published head
# dims (qk_nope 64, qk_rope 32, v 64: Dqk, Dv = 96, 64), so that their
# float32 prefill runs simt at a pair the kernels are built for; the CPU
# tests keep configs.reduced's (16, 8, 16), which no kernel takes
MLA_CARD_DIMS = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                     head_dim=96)
# the MoE layer alone, card vs CPU: the reduced deepseek-v2-lite at
# capacity factor 1.0 over this many tokens, so that assignments drop;
# outputs within MOE_TOL of the largest
MOE_DROP_TOKENS, MOE_TOL = 512, 1e-5
# The vlm, audio and hybrid families.  The Mamba scan's checks (B, S,
# D, N): jamba's d_inner and state at S = 1, 13, 64 and its longest
# prompt, and the reduced config's N = 8 at a ragged shape; held within
# MAMBA_TOL of the largest |y| (and |h|).  Its timed shape is jamba's
# longest prefill; MAMBA_OPS operations per (step, channel, state): the
# exponential, its argument, the two input products, the state's multiply-
# add and y's (2 each), and the group sum's add.
MAMBA_CHECKS = ((1, 1, 8192, 16), (1, 13, 8192, 16), (1, 64, 8192, 16),
                (1, PROMPT_MAX, 8192, 16), (2, 37, 256, 8))
MAMBA_MAIN = (1, PROMPT_MAX, 8192, 16)
MAMBA_TOL = 1e-5
MAMBA_OPS = 9
# the backward kernel's checks (B, S, D, N), each gradient within
# MAMBA_BWD_TOL of its largest magnitude against mamba_scan_bwd_ref: one
# chunk at jamba's width, the reduced config's N = 8 at a ragged shape,
# jamba's longest prompt; its timed shape is jamba's train step
# (JAMBA_TRAIN's batch and sequence).  MAMBA_BWD_OPS operations per (step,
# channel, state), the backward's own (the forward states it needs are not
# counted): the adjoint's multiply-add and carry (3), the ddelta, dx and da
# terms (7), dB's and dC's products (3) and their adds (2)
MAMBA_BWD_CHECKS = ((1, 64, 8192, 16), (2, 13, 256, 8),
                    (1, PROMPT_MAX, 8192, 16))
MAMBA_BWD_TOL = 1e-5
MAMBA_BWD_OPS = 15
# serve_audio: decoder prompts of Whisper's special tokens plus a previous-
# text prompt, at most half its 448-token text context; the cache holds
# that context
AUDIO_PROMPT_MIN, AUDIO_PROMPT_MAX, AUDIO_CACHE = 4, 224, 448
# the flash kernels at these families' shapes (B, Hq, Hkv, Sq, Skv, D,
# causal, kv_len), each attention of the three serve phases at its largest:
# whisper's encoder (non-causal over its 1500 frames), its cross-attention
# in the longest prefill and in a decode tick, its decoder's causal self-
# attention in the longest prefill and in a tick over AUDIO_CACHE (ragged
# fill levels up to the full cache); qwen2-vl's (GQA group 7 at D 128) and
# jamba's (group 4 at D 128) longest prefill and their decode over
# SERVE_CACHE at the decode's ragged fill levels
DECODE_LENS = (1, 129, 700, 1501, 2048, 2900, 3999, 4096)
AUDIO_DECODE_LENS = (4, 5, 37, 129, 224, 225, 256, AUDIO_CACHE)
FLASH_FAMILIES = {
    "whisper_encoder": (1, 12, 12, 1500, 1500, 64, False, None),
    "whisper_cross_prefill": (1, 12, 12, AUDIO_PROMPT_MAX, 1500, 64, False,
                              None),
    "whisper_cross_decode": (SERVE_SLOTS, 12, 12, 1, 1500, 64, False,
                             (1500,) * SERVE_SLOTS),
    "whisper_self_prefill": (1, 12, 12, AUDIO_PROMPT_MAX, AUDIO_PROMPT_MAX,
                             64, True, None),
    "whisper_self_decode": (SERVE_SLOTS, 12, 12, 1, AUDIO_CACHE, 64, True,
                            AUDIO_DECODE_LENS),
    "qwen2vl_prefill": (1, 28, 4, PROMPT_MAX, PROMPT_MAX, 128, True, None),
    "qwen2vl_decode": (SERVE_SLOTS, 28, 4, 1, SERVE_CACHE, 128, True,
                       DECODE_LENS),
    "jamba_prefill": (1, 32, 8, PROMPT_MAX, PROMPT_MAX, 128, True, None),
    "jamba_decode": (SERVE_SLOTS, 32, 8, 1, SERVE_CACHE, 128, True,
                     DECODE_LENS),
}
# serve_hybrid: jamba-v0.1-52b at full width cut to two period-8 blocks
# (all 32 layers are 103 GB in bf16; 24 would be 77.6 GB before any cache)
HYBRID_LAYERS = 16
FLOPS_PER_TRIPLE = 6        # sub, 2 max, 2 fma (2 flops each) per hour
OPS_PER_HOUR = 6            # bucketed sweep: 2 subs, 4 muls of the terms
OPS_PER_OUTPUT = 4          # its scan: sub, 2 muls, add per candidate
# Spin before each timed run: ~2 ms at the H100's ~1.7 GHz clock
HOST_COVER_CYCLES = 3_500_000


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``elapsed_s``), so a run's time can be split by phase."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}),
          flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def plain_chunked(f, w, cs, chunk=PLAIN_CHUNK):
    """The plain version over row chunks (its (R, G, T) temporary at the
    main shape would be 5.6 GB in one piece)."""
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_over_under_ref,
    )
    parts = [
        commitment_sweep_over_under_ref(
            f[i:i + chunk], w[i:i + chunk], cs[i:i + chunk]
        )
        for i in range(0, f.shape[0], chunk)
    ]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def compare(name, got, want):
    """Raw over/under within rtol/atol, the cost curve 2.1 over + under
    within COST_RTOL elementwise; returns the max abs error."""
    (go, gu), (wo, wu) = got, want
    for label, a, b in (("over", go, wo), ("under", gu, wu)):
        torch.testing.assert_close(
            a, b, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name} {label}: {m}"
        )
    cost_k, cost_r = 2.1 * go + gu, 2.1 * wo + wu
    rel = ((cost_k - cost_r).abs() / cost_r.abs().clamp_min(1e-30)).max()
    rel = float(rel)
    if rel > COST_RTOL:
        raise AssertionError(f"{name}: cost-curve rel err {rel} > {COST_RTOL}")
    return max(float((go - wo).abs().max()), float((gu - wu).abs().max())), rel


def main_shape_inputs(dev, seed=0, pools=NUM_POOLS):
    """Demand-like rows (synthetic forecasts repeated over 8 prefixes),
    per-row grids max(f) x linspace(0, 1, G), 0/1 prefix-mask weights —
    the shapes and weights the grid solver hands the kernel (``pools``
    rows of forecasts: the fleet's pools, or pools x scenarios)."""
    from repro_torch.numerics import linspace
    gen = torch.Generator().manual_seed(seed)
    base = 40.0 + 200.0 * torch.rand(pools, 1, generator=gen)
    t = torch.arange(MAIN_T, dtype=torch.float32)
    shape = 1.0 + 0.15 * torch.cos(2 * torch.pi * (t - 15) / 24)
    noise = 1.0 + 0.02 * torch.randn(pools, MAIN_T, generator=gen)
    yhat = (base * shape * noise).to(dev)
    f = yhat.repeat_interleave(HORIZON_WEEKS, 0).contiguous()
    wk = torch.arange(1, HORIZON_WEEKS + 1) * 168
    masks = (t[None, :] < wk[:, None]).to(torch.float32)
    w = masks.repeat(pools, 1).to(dev)
    cs = (f.amax(-1, keepdim=True)
          * linspace(0.0, 1.0, MAIN_G, device=dev)[None]).contiguous()
    return f, w, cs


def phase_device():
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the forecast needs full f32")
    torch.set_float32_matmul_precision("highest")
    emit("device", nvidia_smi=smi(), torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def kernel_modules():
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.generation_turnover import (
        generation_turnover as gk,
    )
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.revocation_walk import revocation_walk as wk
    return {"commitment_sweep": ck, "flash_attention": fk, "rwkv6": lk,
            "revocation_walk": wk, "generation_turnover": gk,
            "mamba_scan": mk}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0
    kernel_modules()["mamba_scan"].BWD_LAUNCHES = 0
    fk = kernel_modules()["flash_attention"]
    for name in fk.LAUNCHES_BY_KERNEL:
        fk.LAUNCHES_BY_KERNEL[name] = 0
    fk.LAUNCHES_INT8 = 0


def read_launches():
    out = {name: mod.LAUNCHES for name, mod in kernel_modules().items()}
    fk = kernel_modules()["flash_attention"]
    out["flash_by_kernel"] = dict(fk.LAUNCHES_BY_KERNEL)
    out["flash_int8"] = fk.LAUNCHES_INT8
    out["mamba_scan_bwd"] = kernel_modules()["mamba_scan"].BWD_LAUNCHES
    return out


def kernel_sources():
    """Every CUDA source of the port by name (flash's three by route)."""
    mods = kernel_modules()
    return {"commitment_sweep": mods["commitment_sweep"].SOURCE,
            **{f"flash_{k}": src for k, src in
               mods["flash_attention"].SOURCES.items()},
            "rwkv6": mods["rwkv6"].SOURCE,
            "revocation_walk": mods["revocation_walk"].SOURCE,
            "generation_turnover": mods["generation_turnover"].SOURCE,
            "mamba_scan": mods["mamba_scan"].SOURCE}


def phase_build():
    from repro_torch.kernels import build as kbuild
    mods, srcs = kernel_modules(), kernel_sources()
    t0 = time.perf_counter()
    libs = kbuild.build(*srcs.values())
    for m in mods.values():
        m.load()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, lib in zip(srcs, libs):
        log = Path(str(lib) + ".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
    emit("build", seconds=secs,
         libraries=[str(lib.relative_to(ROOT)) for lib in libs], ptxas=ptxas)


def sweep_edge_cases(dev):
    """(f, cs, w) cases at the bucketed kernel's edges: candidates
    unsorted, duplicated, all equal, descending (negative demand, as
    amax(f) < 0 makes the grid), exactly equal to some hours' f; rows of
    zero weight; G = 1, T = 1; one row of three years of hours (the fixed
    point's range); G = 4096 (32 candidate tiles)."""
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, lo=0.0, hi=300.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    f, w = rnd(6, 500), rnd(6, 500, lo=0.0, hi=1.0)
    grid = torch.linspace(0.0, 1.0, 50)
    neg = -rnd(6, 500)
    ties = f.clone()
    ties[:, ::7] = 150.0
    cases = {
        "unsorted_candidates": (f, rnd(6, 50), w),
        "duplicate_candidates": (
            f, (torch.randint(0, 6, (6, 50), generator=gen) * 60.0), w),
        "all_equal_candidates": (f, torch.full((6, 50), 120.0), w),
        "descending_grid": (
            neg, neg.amax(-1, keepdim=True) * grid[None], w),
        "f_equals_candidate": (
            ties, torch.tensor([0.0, 75.0, 150.0, 225.0, 300.0]).repeat(6, 1),
            w),
        "zero_weight_rows": (f, rnd(6, 50), w * (torch.arange(6) % 2)[:, None]),
        "G_1": (f, rnd(6, 1), w),
        "T_1": (f[:, :1], rnd(6, 50), w[:, :1]),
        "one_row_3_years": (
            rnd(1, NUM_HOURS), rnd(1, 128), rnd(1, NUM_HOURS, hi=1.0)),
        "G_4096": (f[:4], f[:4].amax(-1, keepdim=True)
                   * torch.linspace(0.0, 1.0, 4096)[None], w[:4]),
    }
    return {k: tuple(x.contiguous().to(dev) for x in v)
            for k, v in cases.items()}


def phase_kernel(dev):
    from repro_torch.kernels.commitment_sweep import ops
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_bucketed_ref,
    )
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, lo=0.0, hi=300.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)).to(dev)

    def same(name, got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: kernel != bucketed plain version "
                                 "bit for bit")

    p, g, t = 5, 37, 300
    f, cs = rnd(p, t), rnd(p, g)
    ends = torch.tensor([[1], [50], [168], [299], [300]])
    prefix = (torch.arange(t)[None, :] < ends).float().to(dev)
    cases = {
        "ragged_weighted": (f, cs, rnd(p, t, lo=0.0, hi=1.0)),
        "ragged_no_weights": (f, cs, None),
        "ragged_prefix_masks": (f, cs, prefix),
        "ragged_shared_grid": (f, cs[0], None),
        "single_row_T": (f[0], cs[0], prefix[2]),
    }
    results = {}
    for name, (fi, ci, wi) in cases.items():
        got = ops.commitment_sweep_over_under(fi, ci, wi)
        want = ops.commitment_sweep_over_under_oracle(fi, ci, wi)
        if fi.dim() == 1:
            want = (want[0][0], want[1][0])
        torch.cuda.synchronize()
        results[name] = compare(name, got, want)
    # The bucketed kernel's edges: against the brute-force plain version
    # within the tolerance, against its own algebra bit for bit.
    for name, (fi, ci, wi) in sweep_edge_cases(dev).items():
        got = ops.commitment_sweep_over_under(fi, ci, wi)
        torch.cuda.synchronize()
        results[name] = compare(name, got, plain_chunked(fi, wi, ci, 1))
        same(name, got, commitment_sweep_bucketed_ref(fi, wi, ci))
    # a non-finite f or w makes its row NaN, never a quiet number
    fi, ci, wi = rnd(3, 64), rnd(3, 9), rnd(3, 64, hi=1.0)
    fi[0, 5], wi[2, 60] = float("nan"), float("inf")
    got = ops.commitment_sweep_over_under(fi, ci, wi)
    nan_rows = [bool(x[r].isnan().all()) for x in got for r in (0, 2)]
    if not (all(nan_rows) and torch.isfinite(got[0][1]).all()
            and torch.isfinite(got[1][1]).all()):
        raise AssertionError("non-finite inputs: rows are not NaN")

    f, w, cs = main_shape_inputs(dev)
    got = ops.commitment_sweep_over_under(f, cs, w)
    want = plain_chunked(f, w, cs)
    torch.cuda.synchronize()
    err, rel = compare("main_shape", got, want)
    same("main_shape", got, commitment_sweep_bucketed_ref(f, w, cs))
    again = ops.commitment_sweep_over_under(f, cs, w)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        raise AssertionError("the same sweep twice differs bit for bit")
    # float64 yardstick: how far each float32 sum is from the exact one
    exact_o = torch.cat([
        (w[i:i + 256, None, :].double() * torch.clamp(
            f[i:i + 256, None, :].double() - cs[i:i + 256, :, None].double(),
            min=0.0)).sum(-1)
        for i in range(0, 1024, 256)
    ])
    kern_rel = float(((got[0][:1024].double() - exact_o).abs()
                      / exact_o.abs().clamp_min(1.0)).max())
    plain_rel = float(((want[0][:1024].double() - exact_o).abs()
                       / exact_o.abs().clamp_min(1.0)).max())
    if kern_rel > plain_rel:
        raise AssertionError(f"kernel's error against float64 {kern_rel} > "
                             f"the plain version's {plain_rel}")

    # Batched launch == one launch per row block, bit for bit (blocks of
    # 1000 rows do not align with the kernel's 8-row blocks).
    bit_exact = True
    for i in range(0, MAIN_P, 1000):
        o1, u1 = ops.commitment_sweep_over_under(
            f[i:i + 1000], cs[i:i + 1000], w[i:i + 1000]
        )
        bit_exact &= bool(torch.equal(o1, got[0][i:i + 1000]))
        bit_exact &= bool(torch.equal(u1, got[1][i:i + 1000]))
    if not bit_exact:
        raise AssertionError("batched sweep != per-block sweeps bit for bit")
    emit("kernel", cases={k: {"max_abs_err": v[0], "cost_rel_err": v[1]}
                          for k, v in results.items()},
         main_shape=[MAIN_P, MAIN_G, MAIN_T], max_abs_err=err,
         cost_rel_err=rel, over_rel_err_vs_f64_kernel=kern_rel,
         over_rel_err_vs_f64_plain=plain_rel, batched_equals_blocks=bit_exact,
         rerun_equals=True, equals_bucketed_plain=True, nan_rows=True)
    return err


def phase_ties(dev):
    """The solvers' sorts on inputs full of ties, card vs CPU, bit for bit.
    The port asks for stable sorts (``jnp.argsort`` is stable); on the CPU
    torch sorts stably either way, on the card only when asked, so this is
    where an unstable sort would show."""
    from repro_torch.core import planner as tpl
    from repro_torch.core import portfolio as tpf
    gen = torch.Generator().manual_seed(3)
    yhat = (torch.randint(0, 12, (64, 3 * 168), generator=gen) * 2.5 + 50.0)
    w_hours = torch.arange(1, 4) * 168
    qs = torch.tensor([0.0, 0.3, 0.55, 0.55, 1.0, 0.9, 0.0, 0.3]).repeat(64, 1)
    per_h = torch.randint(0, 5, (64, 8, 8), generator=gen) * 10.0 + 20.0
    terms = torch.tensor([4, 52, 2, 156, 8, 1, 52, 4])
    has = torch.rand(64, 8, generator=gen) > 0.4
    lo = torch.randint(0, 3, (64, 8), generator=gen)
    # integer widths: their cumulative sums are exact on any device, so a
    # difference can only come from the order the sort chose
    widths = torch.randint(0, 5, (64, 8), generator=gen).float()
    cases = {
        "prefix_weighted_quantiles": lambda d: tpl._prefix_weighted_quantiles(
            yhat.to(d), w_hours.to(d), qs.to(d)),
        "monotone_stack": lambda d: torch.stack(tpl._monotone_stack(
            per_h.to(d), qs.to(d), terms.to(d), 8)),
        "stack_heights": lambda d: tpf._stack_heights(
            has.to(d), lo.to(d), widths.to(d), 10),
    }
    for name, fn in cases.items():
        if not torch.equal(fn(dev).cpu(), fn(torch.device("cpu"))):
            raise AssertionError(f"{name}: card != CPU on tied inputs")
    emit("ties", cases=sorted(cases), card_equals_cpu=True)


def grid_cells(pools, rep, num_grid, demand=None):
    """(S, R) grid-cell width max(yhat)/(G-1) of every replayed week's
    forecast, recomputed on the CPU with the port's forecaster, of the
    fleet's rows or of the (R, T) ``demand`` rows given."""
    from repro_torch.core import forecast as fc
    if demand is None:
        demand = torch.as_tensor(
            pools.demand[:, :(pools.num_hours // 168) * 168])
    state = fc.prefix_fit_state(
        demand, fc.ForecastConfig(), horizon_hours=rep.horizon_weeks * 168,
        min_prefix_hours=rep.start_weeks * 168,
    )
    cells = []
    for w in rep.weeks:
        yhat = fc.predict_from_beta(
            state, fc.solve_prefix(state, int(w)), int(w) * 168,
            rep.horizon_weeks * 168,
        )
        cells.append((yhat.amax(-1) / (num_grid - 1)).numpy())
    return np.stack(cells)


def phase_plan(pools):
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep = plan(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()["commitment_sweep"]
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 savings_vs_one_shot=rep.savings_vs_one_shot)
    if not all(np.isfinite(v) and v > 0 for k, v in costs.items()
               if k != "savings_vs_one_shot"):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if not (np.isfinite(rep.targets).all() and rep.targets.shape
            == (len(rep.weeks), NUM_POOLS, len(rep.options))):
        raise AssertionError("targets are not finite or of the wrong shape")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(
            f"{launches} sweep launches, expected {EXPECTED_LAUNCHES}")
    bill_rel = {k: abs(costs[k] - v) / v for k, v in PLAN_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the grid plan's bill moved: {bill_rel}")
    emit("plan", solver="grid", pools=NUM_POOLS, hours=NUM_HOURS,
         weeks_replayed=len(rep.weeks), wall_s=secs,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         sweep_launches=launches, bill_rel=bill_rel, **costs)
    return rep, launches, secs


def phase_quantile(pools, grid_rep):
    from repro_torch.core.api import PlanRequest, plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = plan(PlanRequest(pools=pools, mode="rolling"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rel = abs(grid_rep.total_cost - rep.total_cost) / rep.total_cost
    if rel > 0.02:
        raise AssertionError(f"grid total {rel:.4f} away from quantile")
    emit("quantile", wall_s=secs, total_cost=rep.total_cost,
         one_shot_cost=rep.one_shot_cost, hindsight_cost=rep.hindsight_cost,
         grid_vs_quantile_rel=rel)


def count_syncs(fn):
    """(fn(), the host syncs it made), counted by CUDA's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


class CpuRefs:
    """The CPU references of the card-vs-CPU checks, each computed by a
    child process of its own (``chip_smoke.py --cpu-ref NAME DIR``, which
    sees no card) while this process drives the card; a phase starts its
    reference, makes its card side and defers its check, and
    :meth:`finish` makes the checks in order, waiting for each
    reference."""

    def __init__(self):
        self.dir = ROOT / "build" / "chip_smoke" / "cpu_ref"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.procs: dict = {}
        self.checks: list = []

    def start(self, name: str, calls: list) -> None:
        """Start the child computing ``calls``: each ``("replan", pools,
        kwargs)`` or ``("plan", request)``, on the CPU."""
        import pickle
        (self.dir / f"{name}.out.pkl").unlink(missing_ok=True)
        with open(self.dir / f"{name}.in.pkl", "wb") as f:
            pickle.dump(calls, f)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.procs[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-ref",
             name, str(self.dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def get(self, name: str) -> dict:
        """The child's results (``reports``, its ``wall_s``); raises if it
        failed."""
        import pickle
        p = self.procs.pop(name)
        _, err = p.communicate(timeout=CPU_REF_TIMEOUT)
        if p.returncode != 0:
            raise AssertionError(f"CPU reference {name} exited "
                                 f"{p.returncode}:\n{err[-6000:]}")
        with open(self.dir / f"{name}.out.pkl", "rb") as f:
            return pickle.load(f)

    def defer(self, check) -> None:
        self.checks.append(check)

    def finish(self) -> None:
        for check in self.checks:
            check()
        self.checks = []

    def close(self) -> None:
        import shutil
        for p in self.procs.values():
            p.kill()
            p.wait()
        self.procs = {}
        shutil.rmtree(self.dir, ignore_errors=True)


def cpu_ref(name: str, out_dir: str) -> int:
    """A child of :class:`CpuRefs`: the calls in ``NAME.in.pkl`` made on
    the CPU, their reports and the wall seconds written to
    ``NAME.out.pkl``."""
    import pickle

    from repro_torch.core.api import plan
    from repro_torch.core.replan import replan_fleet_pools
    torch.set_num_threads(CPU_REF_THREADS)
    d = Path(out_dir)
    with open(d / f"{name}.in.pkl", "rb") as f:
        calls = pickle.load(f)
    t0 = time.perf_counter()
    reports = [replan_fleet_pools(c[1], device="cpu", **c[2])
               if c[0] == "replan" else plan(c[1], device="cpu")
               for c in calls]
    out = {"reports": reports, "wall_s": time.perf_counter() - t0,
           "threads": CPU_REF_THREADS}
    with open(d / f"{name}.out.pkl.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(d / f"{name}.out.pkl.tmp", d / f"{name}.out.pkl")
    return 0


def phase_cpu(pools, refs):
    from repro_torch.core.demand import PoolSet
    from repro_torch.core.replan import replan_fleet_pools
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    kw = dict(solver="grid", num_grid=NUM_GRID)
    refs.start("cpu", [("replan", sub, kw)])
    # Count the host syncs of the card replay: set-up and the final copy to
    # the host sync a fixed few times; a sync inside the weekly loop would
    # show up once per replayed week.
    # This is also the process's first planner call on the card, so its
    # time includes CUDA library initialization.
    t0 = time.perf_counter()
    card, syncs = count_syncs(lambda: replan_fleet_pools(sub, **kw))
    card_s = time.perf_counter() - t0
    if syncs >= len(card.weeks):
        raise AssertionError(
            f"{syncs} host syncs in a {len(card.weeks)}-week card replay: "
            "the weekly loop reads the device back")
    k = len(card.options)
    for i, w in enumerate(card.weeks):
        np.testing.assert_allclose(
            card.ladders.option_widths(int(w) * 168, k), card.active[i],
            rtol=1e-4, atol=1e-4)

    def check():
        ref = refs.get("cpu")
        cpu = ref["reports"][0]
        rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / abs(getattr(cpu, k))
               for k in ("total_cost", "one_shot_cost", "hindsight_cost")}
        if max(rel.values()) > 1e-4:
            raise AssertionError(f"card vs CPU totals: {rel}")
        # One grid cell, max(yhat)/(G-1), plus the drift of the grid itself:
        # its top is max(yhat), which may move by the forecasts' rel 1e-4,
        # and a threshold at cell g moves g times as far.
        cells = grid_cells(sub, cpu, NUM_GRID)[:, :, None]     # (S, P, 1)
        diff = np.abs(card.targets - cpu.targets)
        if (diff > cells * (1.0 + (NUM_GRID - 1) * 1e-4)).any():
            raise AssertionError(
                "card vs CPU targets differ by more than one grid cell "
                f"(worst {float((diff / cells).max())} cells)")
        emit("cpu", pools=16, weeks=len(card.weeks), cpu_wall_s=ref["wall_s"],
             cpu_threads=ref["threads"], card_wall_s_first_call=card_s,
             total_rel=rel, card_replay_host_syncs=syncs,
             max_target_diff_cells=float((diff / cells).max()),
             ladder_matches_active=True)

    refs.defer(check)


def fit_work(p, t, d, iters):
    """Float32 operations and bytes of fit_batched on (P, T) histories with
    D design columns: the shared gram, then per IRLS pass P weighted grams
    (2 P T D^2), their right-hand sides and residuals (2 P T D each).
    Bytes: the history read once, the coefficients written once."""
    flops = 2 * t * d * d + 2 * p * t * d + iters * (
        2 * p * t * d * d + 4 * p * t * d)
    return flops, 4 * (p * t + p * d)


def one_shot_rel(got, want):
    """Each one-shot cost of ``got`` against ``want``, as a share of the
    bill: the two totals (the pools' and the aggregate plan's) relative to
    themselves, the committed and on-demand parts relative to the pools'
    total, the premium and the savings, fractions of a bill, absolutely.
    (On-demand alone is the area above the stack, ~1% of the bill; a
    forecast that moves by 1e-5 moves it by ~3e-4 of itself.)"""
    total = abs(want.total_cost)
    scale = {"total_cost": total, "aggregate_cost": abs(want.aggregate_cost),
             "committed_cost": total, "on_demand_cost": total,
             "pooling_premium": 1.0, "savings_vs_on_demand": 1.0}
    return {k: abs(getattr(got, k) - getattr(want, k)) / scale[k]
            for k in ONE_SHOT_COSTS}


def phase_one_shot(pools, dev):
    """The default request, PlanRequest(pools=fleet): the one-shot plan."""
    from repro_torch.core import commitment as cm
    from repro_torch.core import forecast as fc
    from repro_torch.core import planner as tpl
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.demand import PoolSet
    from repro_torch.kernels.commitment_sweep import ops

    # the first 16 pools: the card against the CPU, and a small plan's syncs
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    cpu = plan(PlanRequest(pools=sub), device="cpu")
    # counted on a second call: the first in a process also initializes
    # CUDA state, which synchronizes once
    card16, _ = count_syncs(lambda: plan(PlanRequest(pools=sub)))
    _, syncs16 = count_syncs(lambda: plan(PlanRequest(pools=sub)))
    card_cpu_rel = one_shot_rel(card16, cpu)
    if max(card_cpu_rel.values()) > CARD_CPU_RTOL:
        raise AssertionError(f"one-shot card vs CPU totals: {card_cpu_rel}")
    yhat_rel = float(np.abs(card16.forecasts / cpu.forecasts - 1.0).max())
    np.testing.assert_array_equal(card16.widths > 0, cpu.widths > 0)
    np.testing.assert_allclose(card16.widths, cpu.widths, **STACK_TOL)
    np.testing.assert_allclose(card16.levels, cpu.levels, **STACK_TOL)

    # the whole fleet: the main path
    req = PlanRequest(pools=pools)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = plan(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()["commitment_sweep"]
    peak = torch.cuda.max_memory_allocated()
    if launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the one-shot "
                             f"plan, expected {EXPECTED_ONE_SHOT_LAUNCHES}")
    _, syncs = count_syncs(lambda: plan(req))
    repeats = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan(req)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    if syncs != syncs16:
        raise AssertionError(f"host syncs grow with the pools: {syncs16} at "
                             f"16 pools, {syncs} at {NUM_POOLS}")
    costs = {k: getattr(res, k) for k in ONE_SHOT_COSTS}
    if not all(np.isfinite(v) for v in costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {costs}")
    if not (res.widths[~res.available] == 0.0).all():
        raise AssertionError("widths bought off a pool's cloud")
    if not math.isclose(res.total_cost,
                        res.committed_cost + res.on_demand_cost,
                        rel_tol=1e-12):
        raise AssertionError("total != committed + on-demand")
    bill_rel = {k: abs(getattr(res, k) - v) / abs(v)
                for k, v in ONE_SHOT_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot bill moved: {bill_rel}")
    per_pool_total = math.fsum(e.spend.total for e in res.per_pool)

    # the spend's sweep: one launch over the pools == a launch per block
    eval_h = HORIZON_WEEKS * 168
    actual = torch.as_tensor(pools.demand[:, -eval_h:]).to(dev)
    level = torch.as_tensor(res.widths).to(dev).sum(-1, keepdim=True)
    got = ops.commitment_sweep_over_under(actual, level)
    blocks_equal = all(
        torch.equal(ops.commitment_sweep_over_under(
            actual[i:i + 100], level[i:i + 100])[0], got[0][i:i + 100])
        for i in range(0, NUM_POOLS, 100))
    if not blocks_equal:
        raise AssertionError("the spend's sweep != a launch per row block")
    spend_err, spend_rel = compare(
        "one_shot_spend", got,
        plain_chunked(actual, torch.ones_like(actual), level))

    # the batched fit alone, by CUDA events, beside its bound
    hist = torch.as_tensor(pools.demand[:, :-eval_h]).to(dev)
    model = fc.fit_batched(hist)
    torch.cuda.synchronize()
    fit_ms = median_ms(lambda: fc.fit_batched(hist), 5)
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name else "sxm"]
    fit_flops, fit_bytes = fit_work(*hist.shape, model.beta.shape[-1],
                                    model.cfg.irls_iters)
    fit_bound = bound(fit_flops, fit_bytes, peaks["fp32_flops"], peaks)
    fit_shape = list(hist.shape) + [model.beta.shape[-1]]
    del hist, model

    # where the plan's time goes: device busy time and kernels by name
    prof_summary, _ = profiled(lambda: plan(req))

    # the grid+refine solver on the card against its plain version
    f, _, _ = main_shape_inputs(dev)
    c_card = ops.optimal_commitment_sweep(f)
    c_plain = torch.cat([ops.optimal_commitment_sweep_oracle(f[i:i + 512])
                         for i in range(0, MAIN_P, 512)])
    exact = cm.commitment_cost(f, cm.optimal_commitment_quantile(f))
    over_exact = {k: float((cm.commitment_cost(f, c) / exact).max() - 1.0)
                  for k, c in (("card", c_card), ("plain", c_plain))}
    if max(over_exact.values()) > SWEEP_COST_BOUND:
        raise AssertionError(f"grid+refine above the exact cost: {over_exact}")
    del f

    # Algorithm 1's golden-section path on one pool, card vs CPU
    hist0 = torch.as_tensor(pools.demand[0, :-eval_h])
    g_card = tpl.plan_commitment(hist0.to(dev), solver="golden")
    g_cpu = tpl.plan_commitment(hist0, solver="golden")
    golden_rel = abs(g_card.commitment - g_cpu.commitment) / g_cpu.commitment
    np.testing.assert_allclose(g_card.per_horizon_levels.cpu().numpy(),
                               g_cpu.per_horizon_levels.numpy(), rtol=1e-3)
    if golden_rel > 1e-3:
        raise AssertionError(f"golden plan card vs CPU: rel {golden_rel}")

    emit("one_shot", pools=NUM_POOLS, hours=NUM_HOURS,
         horizon_weeks=HORIZON_WEEKS, wall_s=secs, wall_s_repeats=repeats,
         max_memory_allocated=peak,
         sweep_launches=launches, host_syncs=syncs, host_syncs_16=syncs16,
         bill_rel=bill_rel, card_vs_cpu_16_rel=card_cpu_rel,
         card_vs_cpu_16_forecast_rel=yhat_rel,
         per_pool_total_rel=abs(per_pool_total - res.total_cost)
         / res.total_cost,
         spend_batched_equals_blocks=blocks_equal,
         spend_max_abs_err=spend_err, spend_cost_rel_err=spend_rel,
         fit_ms=fit_ms, fit_bound_ms=fit_bound[0], fit_bound_by=fit_bound[1],
         fit_flops=fit_flops, fit_shape_p_t_d=fit_shape, **prof_summary,
         grid_refine_over_exact=over_exact,
         golden_card_vs_cpu_rel=golden_rel, nvidia_smi=smi(), **costs)
    return launches


def timed(fn, counted):
    """(fn(), wall seconds, launches of kernel ``counted`` in it, peak
    memory), with every launch count set to 0 just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (res, secs, read_launches()[counted],
            torch.cuda.max_memory_allocated())


def phase_spot(pools, grid_rep, refs):
    """The spot band on the whole fleet: the rolling grid plan and the
    one-shot plan with spot=True (the main path, launches counted from 0
    around each), both modes on the first 16 pools card against the CPU,
    then the rolling report replayed against 32 revocation draws."""
    from repro_torch.capacity.simulator import replay_spot_plan
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    from repro_torch.core.demand import PoolSet
    out = {}
    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    # the first 16 pools, card against CPU: the CPU's plans start now
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    modes = (("rolling", ("total_cost", "one_shot_cost"),
              PlanRequest(pools=sub, mode="rolling", rolling=rolling,
                          spot=True)),
             ("one_shot", ("total_cost", "committed_cost", "on_demand_cost"),
              PlanRequest(pools=sub, spot=True)))
    refs.start("spot", [("plan", req) for _, _, req in modes])
    rep, secs, launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling, spot=True)),
        "commitment_sweep")
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 spot_cost=float(rep.spot_cost.sum()))
    if not all(np.isfinite(v) and v > 0 for v in costs.values()):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the spot plan, "
                             f"expected {EXPECTED_LAUNCHES}")
    if not rep.total_cost < grid_rep.total_cost:
        raise AssertionError(
            f"spot total {rep.total_cost} not below the spot-free "
            f"{grid_rep.total_cost}")
    if not (rep.spot_floor >= rep.active.sum(-1) - 1e-3).all():
        raise AssertionError("a spot floor below the committed stack top")
    out["bill_rel"] = {k: abs(costs[k] - v) / v
                       for k, v in SPOT_BILL.items()}
    if max(out["bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the spot plan's bill moved: "
                             f"{out['bill_rel']}")
    out.update(rolling_wall_s=secs, rolling_max_memory_allocated=peak,
               rolling_sweep_launches=launches,
               rolling_vs_spot_free=rep.total_cost / grid_rep.total_cost,
               rolling=costs)

    one, secs, launches, peak = timed(
        lambda: plan(PlanRequest(pools=pools, spot=True)),
        "commitment_sweep")
    one_costs = {k: getattr(one, k) for k in ONE_SHOT_COSTS + ("spot_cost",)}
    if not all(np.isfinite(v) for v in one_costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {one_costs}")
    if launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the one-shot "
                             f"spot plan, expected "
                             f"{EXPECTED_ONE_SHOT_LAUNCHES}")
    out["one_shot_bill_rel"] = {k: abs(one_costs[k] - v) / abs(v)
                                for k, v in SPOT_ONE_SHOT_BILL.items()}
    if max(out["one_shot_bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot spot bill moved: "
                             f"{out['one_shot_bill_rel']}")
    out.update(one_shot_wall_s=secs, one_shot_max_memory_allocated=peak,
               one_shot_sweep_launches=launches, one_shot=one_costs)

    # the first 16 pools, card against CPU, as shares of the CPU bill
    cards = [plan(req) for _, _, req in modes]

    def check():
        ref = refs.get("spot")
        card_cpu = {}
        for (mode, fields, _), card, cpu in zip(modes, cards, ref["reports"]):
            bill = abs(cpu.total_cost)
            rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / bill
                   for k in fields}
            rel["spot_cost"] = abs(float(np.sum(card.spot_cost))
                                   - float(np.sum(cpu.spot_cost))) / bill
            if max(rel.values()) > CARD_CPU_RTOL:
                raise AssertionError(f"spot {mode} card vs CPU: {rel}")
            card_cpu[mode] = rel
        emit("spot_card_vs_cpu", pools=16, cpu_wall_s=ref["wall_s"],
             cpu_threads=ref["threads"], card_vs_cpu_16_rel=card_cpu)

    refs.defer(check)

    # the Monte-Carlo replay of the rolling plan: the walk on the card
    rr, secs, walk_launches, peak = timed(
        lambda: replay_spot_plan(pools, rep, num_draws=SPOT_REPLAY_DRAWS),
        "revocation_walk")
    realized_rel = abs(rr.realized_cost - rr.planned_cost) / rr.planned_cost
    if walk_launches != EXPECTED_WALK_LAUNCHES:
        raise AssertionError(f"{walk_launches} walk launches in the replay")
    if not (rr.meets_target and rr.fleet_availability >= SPOT_TARGET):
        raise AssertionError(
            f"replay misses its target: min pool availability "
            f"{float(rr.mean_availability.min())}, fleet "
            f"{rr.fleet_availability}")
    if realized_rel > SPOT_REALIZED_RTOL:
        raise AssertionError(f"realized cost {realized_rel} from planned")

    # where the time goes: the spot plan and the replay under the profiler
    for label, fn in (
            ("rolling_profile", lambda: plan(PlanRequest(
                pools=pools, mode="rolling", rolling=rolling, spot=True))),
            ("replay_profile", lambda: replay_spot_plan(
                pools, rep, num_draws=SPOT_REPLAY_DRAWS))):
        out[label] = profiled(fn)[0]
    emit("spot", pools=NUM_POOLS, hours=NUM_HOURS, solver="grid",
         replay=dict(draws=rr.num_draws, wall_s=secs,
                     max_memory_allocated=peak, walk_launches=walk_launches,
                     meets_target=rr.meets_target,
                     min_pool_availability=float(rr.mean_availability.min()),
                     fleet_availability=rr.fleet_availability,
                     planned_cost=rr.planned_cost,
                     realized_cost=rr.realized_cost,
                     realized_vs_planned_rel=realized_rel,
                     realized_spot_cost=rr.realized_spot_cost,
                     fallback_on_demand_cost=rr.fallback_on_demand_cost,
                     requeue_cost=rr.requeue_cost,
                     shortfall_chip_hours=rr.shortfall_chip_hours),
         nvidia_smi=smi(), **out)
    return walk_launches, rep


def phase_migration(grid_rep, refs):
    """The migration and convertible bands (a main path): the turnover
    fleet synthesized on the card through the turnover kernel (launches
    counted from 0 around it), the rolling grid plan and the one-shot plan
    with migration=True and convertible=True, and the migration-blind
    rolling grid plan on the same fleet (sweep launches counted from 0
    around each); then both modes on the 16 pools of MIGRATION_REGIONS,
    card against the CPU.  Returns (turnover launches, sweep launches of
    the aware rolling plan, the turnover fleet, the aware rolling
    report)."""
    from repro_torch.capacity import generations as gn
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    from repro_torch.core.demand import PoolSet
    from repro_torch.data import traces
    pools, synth_s, turnover_launches, _ = timed(
        lambda: traces.synthetic_pool_set(
            num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0,
            migration=True),
        "generation_turnover")
    if turnover_launches != EXPECTED_TURNOVER_LAUNCHES:
        raise AssertionError(
            f"{turnover_launches} turnover launches synthesizing the fleet")
    edges = gn.migration_edges(pools.keys)
    regions = {k[1] for k in pools.keys}
    clouds = sorted({k[0] for k in pools.keys})
    if (edges.num_edges, len(regions), len(clouds)) != (
            NUM_POOLS // 2, NUM_POOLS // 8, 3):
        raise AssertionError(
            f"turnover fleet: {edges.num_edges} edges, {len(regions)} "
            f"regions, clouds {clouds}")
    if not (np.isfinite(pools.demand).all() and (pools.demand >= 0).all()):
        raise AssertionError("turnover fleet: non-finite or negative demand")
    out = dict(fleet=dict(pools=NUM_POOLS, hours=NUM_HOURS,
                          edges=edges.num_edges, regions=len(regions),
                          clouds=clouds, synth_s=synth_s,
                          turnover_launches=turnover_launches))

    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    bands = dict(migration=True, convertible=True)
    # the 16 pools of two regions (whole pairs, all three clouds), card
    # against CPU: the CPU's plans start now
    keep = [i for i, key in enumerate(pools.keys)
            if key[1] in MIGRATION_REGIONS]
    sub = PoolSet(keys=tuple(pools.keys[i] for i in keep),
                  demand=pools.demand[keep],
                  configs=tuple(pools.configs[i] for i in keep))
    modes = (("rolling", ("total_cost", "one_shot_cost"),
              lambda r: float(r.conv_committed_cost.sum()),
              PlanRequest(pools=sub, mode="rolling", rolling=rolling,
                          **bands)),
             ("one_shot", ("total_cost", "committed_cost", "on_demand_cost"),
              lambda r: r.conv_cost,
              PlanRequest(pools=sub, **bands)))
    refs.start("migration", [("plan", m[3]) for m in modes])
    rep, secs, launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling, **bands)),
        "commitment_sweep")
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 convertible_cost=float(rep.conv_committed_cost.sum()))
    if not all(np.isfinite(v) and v > 0 for v in costs.values()):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if launches != EXPECTED_MIGRATION_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the migration "
                             f"plan, expected {EXPECTED_MIGRATION_LAUNCHES}")
    k = len(rep.options)
    for i, w in enumerate(rep.weeks):
        np.testing.assert_allclose(
            rep.ladders.option_widths(int(w) * 168, k), rep.active[i],
            rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            rep.conv_ladders.option_widths(int(w) * 168,
                                           len(rep.conv_options)),
            rep.conv_active[i], rtol=1e-4, atol=1e-3)
    out["bill_rel"] = {kk: abs(costs[kk] - v) / v
                       for kk, v in MIGRATION_BILL.items()}
    if max(out["bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the migration plan's bill moved: "
                             f"{out['bill_rel']}")
    out.update(rolling_wall_s=secs, rolling_max_memory_allocated=peak,
               rolling_sweep_launches=launches, rolling=costs,
               convertible_final_width=float(rep.conv_active[-1].sum()))

    one, secs, one_launches, peak = timed(
        lambda: plan(PlanRequest(pools=pools, **bands)), "commitment_sweep")
    one_costs = {kk: getattr(one, kk) for kk in ONE_SHOT_COSTS
                 + ("conv_cost",)}
    if not all(np.isfinite(v) for v in one_costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {one_costs}")
    if one_launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{one_launches} sweep launches in the "
                             "one-shot migration plan")
    out["one_shot_bill_rel"] = {
        kk: abs(one_costs[kk] - v) / abs(v)
        for kk, v in MIGRATION_ONE_SHOT_BILL.items()}
    if max(out["one_shot_bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot migration bill moved: "
                             f"{out['one_shot_bill_rel']}")
    out.update(one_shot_wall_s=secs, one_shot_max_memory_allocated=peak,
               one_shot_sweep_launches=one_launches, one_shot=one_costs,
               one_shot_conv_width=float(one.conv_widths.sum()),
               one_shot_conv_alloc=float(one.conv_alloc.sum()))

    blind, secs, blind_launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling)), "commitment_sweep")
    if blind_launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{blind_launches} sweep launches in the "
                             "blind plan")
    out.update(blind_wall_s=secs, blind_max_memory_allocated=peak,
               blind_sweep_launches=blind_launches,
               blind_total_cost=blind.total_cost,
               aware_vs_blind_margin=1.0 - rep.total_cost / blind.total_cost,
               aware_vs_blind_wall_s=out["rolling_wall_s"] - secs,
               turnover_fleet_vs_grid_fleet_bill=(
                   blind.total_cost / grid_rep.total_cost))

    # those 16 pools, card against CPU, as shares of the CPU bill
    cards = [plan(m[3]) for m in modes]

    def check():
        ref = refs.get("migration")
        card_cpu = {}
        for (mode, fields, conv, _), card, cpu in zip(modes, cards,
                                                      ref["reports"]):
            bill = abs(cpu.total_cost)
            rel = {kk: abs(getattr(card, kk) - getattr(cpu, kk)) / bill
                   for kk in fields}
            rel["convertible_cost"] = abs(conv(card) - conv(cpu)) / bill
            if max(rel.values()) > CARD_CPU_RTOL:
                raise AssertionError(f"migration {mode} card vs CPU: {rel}")
            card_cpu[mode] = rel
        emit("migration_card_vs_cpu", cpu_wall_s=ref["wall_s"],
             cpu_threads=ref["threads"],
             card_vs_cpu_16_rel=dict(pools=len(keep), **card_cpu))

    refs.defer(check)
    out["planted_one_shot"] = planted_one_shot()
    emit("migration", solver="grid", nvidia_smi=smi(), **out)
    return turnover_launches, launches, pools, rep


def planted_one_shot():
    """The one-shot plan's convertible band where the fleet buys one: the
    planted two-edge table on NUM_POOLS pools over PLANTED_WEEKS, card
    against CPU (costs as shares of the CPU bill, the cloud bands and their
    allocation within the stack tolerance), a nonzero band, and the bill
    within rel 1e-4 of PLANTED_ONE_SHOT_BILL."""
    from repro_torch.capacity import generations as gn
    from repro_torch.capacity import pricing
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.data import traces
    plant = gn.MigrationConfig(generations=tuple(
        pricing.Generation(*g) for g in PLANTED_GENERATIONS))
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=PLANTED_WEEKS * 168, seed=3,
        migration=plant)
    req = PlanRequest(pools=pools, horizon_weeks=PLANTED_HORIZON_WEEKS,
                      migration=plant, convertible=True)
    cpu, card = plan(req, device="cpu"), plan(req)
    if not card.conv_cost > 0.0:
        raise AssertionError("planted fleet: the one-shot plan bought no "
                             "convertible band")
    bill = abs(cpu.total_cost)
    rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / bill
           for k in ("total_cost", "committed_cost", "on_demand_cost",
                     "conv_cost")}
    if max(rel.values()) > CARD_CPU_RTOL:
        raise AssertionError(f"planted one-shot card vs CPU: {rel}")
    np.testing.assert_allclose(card.conv_widths, cpu.conv_widths,
                               **STACK_TOL)
    np.testing.assert_allclose(card.conv_alloc, cpu.conv_alloc, **STACK_TOL)
    bill_rel = {k: abs(getattr(card, k) - v) / abs(v)
                for k, v in PLANTED_ONE_SHOT_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the planted one-shot bill moved: {bill_rel}")
    return dict(pools=NUM_POOLS, weeks=PLANTED_WEEKS,
                edges=card.migration_edges.num_edges,
                conv_cost=card.conv_cost, total_cost=card.total_cost,
                conv_widths=card.conv_widths.sum(-1).tolist(),
                conv_clouds=list(card.conv_clouds),
                card_vs_cpu_rel=rel, bill_rel=bill_rel)


def bits_equal(name, got, want):
    """Raise unless the arrays hold the same bits (and shape)."""
    a = np.ascontiguousarray(np.asarray(got))
    b = np.ascontiguousarray(np.asarray(want))
    if a.shape != b.shape or a.tobytes() != b.tobytes():
        diff = (np.asarray(a != b).sum() if a.shape == b.shape
                else f"shapes {a.shape} vs {b.shape}")
        raise AssertionError(f"{name}: not bit for bit ({diff} differ)")


def scenario0_equal(label, batch, base, fields):
    """Scenario 0 of a batched report against the unbatched report, bit
    for bit: per-week arrays, weekly costs and the bills."""
    for name in fields:
        bits_equal(f"{label} {name}", getattr(batch, name)[:, 0],
                   getattr(base, name))
    bits_equal(f"{label} weekly_cost", batch.weekly_cost[:, 0],
               base.weekly_cost)
    pairs = [("scenario_cost", "total_cost")]
    if base.one_shot_cost is not None:
        pairs += [("scenario_one_shot_cost", "one_shot_cost"),
                  ("scenario_hindsight_cost", "hindsight_cost")]
        bits_equal(f"{label} hindsight_widths", batch.hindsight_widths[0],
                   base.hindsight_widths)
    for mine, theirs in pairs:
        if float(getattr(batch, mine)[0]) != getattr(base, theirs):
            raise AssertionError(
                f"{label}: {mine}[0] {float(getattr(batch, mine)[0])} != "
                f"{theirs} {getattr(base, theirs)}")
    return True


def perturbations_on_card(pools):
    """Each perturbation's scenario rows built on the card against the
    port's plain numpy rows (the reference's arithmetic) on the host, bit
    for bit: growth on every pool, the others on SCEN_SAMPLED_POOLS."""
    from repro_torch.data import scenarios as sc
    demand = pools.demand[:, :(pools.num_hours // 168) * 168]
    checked = {}
    for family in sc.PERTURBATIONS[1:]:
        cfg = sc.ScenarioConfig(n_scenarios=SCEN_N, family=family)
        rows = (range(NUM_POOLS) if family == "growth"
                else SCEN_SAMPLED_POOLS)
        for s in SCEN_CHECKED:
            card = sc.scenario_block(demand, cfg, s, s + 1)[0]
            got = card[list(rows)].cpu().numpy()
            want = np.stack([
                sc._perturb(family, demand[p], sc._rng(family, 0, s, p))
                for p in rows]).astype(np.float32)
            bits_equal(f"{family} scenario {s}", got, want)
        checked[family] = len(rows) * len(SCEN_CHECKED)
    return checked


def phase_scenarios(pools, grid_rep, plan_s, plan_profile, spot_rep,
                    mig_pools, mig_rep):
    """Scenario batching on the card (a main path, launches counted from 0
    around each plan): the perturbations against their numpy rows; the
    fleet-scale batch (N = 32 growth, quantile) with scenario 0 against the
    unbatched replay; api.plan with the grid solver and N = 32 regime
    futures at phase plan's settings, scenario 0 against phase plan's
    report, 234 sweep launches, wall time, peak memory, device busy under
    the profiler; an N = 8 spot plan against phase spot's report and
    replay_spot_plan of scenario 3; an N = 4 aware plan against phase
    migration's report (468 launches); and on 16 pools over the fleet's
    first 39 weeks N = 4 chunked by 3 against the unchunked run (bits) and
    against the CPU."""
    from repro_torch.capacity.simulator import replay_spot_plan
    from repro_torch.core.api import (
        PlanRequest, RollingConfig, ScenarioConfig, plan)
    from repro_torch.core.demand import PoolSet
    from repro_torch.core.replan import replan_fleet_pools
    from repro_torch.data import scenarios as sc
    t0 = time.perf_counter()
    out = {"perturbed_rows_checked": perturbations_on_card(pools),
           "perturbation_check_s": time.perf_counter() - t0}
    per_week = ("targets", "increments", "active", "committed_cost",
                "on_demand_cost", "utilization")

    # the fleet-scale setting: N = 32 growth futures, quantile solver
    cfg = ScenarioConfig(n_scenarios=SCEN_N, family="growth")
    batch, secs, _, peak = timed(lambda: replan_fleet_pools(
        pools, scenarios=cfg, **SCEN_FLEET_KW), "commitment_sweep")
    single, single_s, _, single_peak = timed(lambda: replan_fleet_pools(
        pools, **SCEN_FLEET_KW), "commitment_sweep")
    scenario0_equal("fleet scale", batch, single, per_week)
    if not np.isfinite(batch.scenario_cost).all():
        raise AssertionError("fleet scale: non-finite scenario costs")
    out["fleet_scale"] = dict(
        scenarios=SCEN_N, family="growth", solver="quantile",
        weeks_replayed=len(batch.weeks), wall_s=secs,
        max_memory_allocated=peak, unbatched_wall_s=single_s,
        unbatched_max_memory_allocated=single_peak,
        scenario0_bit_for_bit=True,
        scenario_cost_mean=float(batch.scenario_cost.mean()),
        scenario_cost_p95=float(np.quantile(batch.scenario_cost, 0.95)))

    # the grid plan at phase plan's settings with N = 32 regime futures
    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    req = PlanRequest(pools=pools, mode="rolling", rolling=rolling,
                      scenarios=ScenarioConfig(n_scenarios=SCEN_N,
                                               family="regime"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the {SCEN_N}-"
                             f"scenario plan, expected {EXPECTED_LAUNCHES}")
    if rep.targets.shape != (len(rep.weeks), SCEN_N, NUM_POOLS,
                             len(rep.options)):
        raise AssertionError(f"scenario targets shape {rep.targets.shape}")
    scenario0_equal("grid plan", rep, grid_rep, per_week)
    # phase sharded's ranks hold their merged report to this one
    sharded_dir().mkdir(parents=True, exist_ok=True)
    np.savez(sharded_dir() / "scenarios.npz", **report_values(rep))
    cr = rep.scenario_cr
    if not (np.isfinite(cr).all() and (rep.scenario_cost > 0).all()):
        raise AssertionError("grid plan: non-finite scenario ratios")
    summary, _ = profiled(lambda: plan(req))
    out["grid_plan"] = dict(
        scenarios=SCEN_N, family="regime", rows=SCEN_N * NUM_POOLS,
        sweep_rows=SCEN_N * NUM_POOLS * HORIZON_WEEKS, wall_s=secs,
        max_memory_allocated=peak, sweep_launches=launches,
        scenario0_bit_for_bit=True, plan_phase_wall_s=plan_s,
        plan_phase_device_busy_s=plan_profile["device_busy_s"],
        plan_phase_device_busy_share=plan_profile[
            "device_busy_share_of_profiled"],
        profile=summary, summary={
            k: v for k, v in rep.summary().items()
            if k.startswith("scenario_") or k == "total_cost"})

    # N = 8 spot plan; one scenario's Monte-Carlo replay
    req = PlanRequest(pools=pools, mode="rolling", rolling=rolling,
                      spot=True, scenarios=ScenarioConfig(
                          n_scenarios=SCEN_SPOT_N, family="regime"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the spot "
                             "scenario plan")
    scenario0_equal("spot plan", rep, spot_rep,
                    per_week + ("spot_floor", "spot_cost", "spot_volume"))
    rr, replay_s, walk_launches, replay_peak = timed(
        lambda: replay_spot_plan(pools, rep, num_draws=SPOT_REPLAY_DRAWS,
                                 scenario=SCEN_SPOT_REPLAYED),
        "revocation_walk")
    realized_rel = abs(rr.realized_cost - rr.planned_cost) / rr.planned_cost
    if walk_launches != EXPECTED_WALK_LAUNCHES:
        raise AssertionError(f"{walk_launches} walk launches in the replay")
    if rr.planned_cost != float(rep.scenario_cost[SCEN_SPOT_REPLAYED]):
        raise AssertionError("the replay's planned bill is not its "
                             "scenario's")
    if not (rr.meets_target and rr.fleet_availability >= SPOT_TARGET):
        raise AssertionError(
            f"scenario {SCEN_SPOT_REPLAYED} replay misses its target: "
            f"{float(rr.mean_availability.min())}")
    if realized_rel > SPOT_REALIZED_RTOL:
        raise AssertionError(f"scenario replay realized {realized_rel} "
                             "from planned")
    out["spot"] = dict(
        scenarios=SCEN_SPOT_N, wall_s=secs, max_memory_allocated=peak,
        sweep_launches=launches, scenario0_bit_for_bit=True,
        replay=dict(scenario=SCEN_SPOT_REPLAYED, draws=rr.num_draws,
                    wall_s=replay_s, max_memory_allocated=replay_peak,
                    walk_launches=walk_launches,
                    min_pool_availability=float(rr.mean_availability.min()),
                    fleet_availability=rr.fleet_availability,
                    planned_cost=rr.planned_cost,
                    realized_vs_planned_rel=realized_rel))

    # N = 4 aware plan on the turnover fleet
    req = PlanRequest(pools=mig_pools, mode="rolling", rolling=rolling,
                      migration=True, convertible=True,
                      scenarios=ScenarioConfig(n_scenarios=SCEN_AWARE_N,
                                               family="scale"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_MIGRATION_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the aware "
                             f"scenario plan, expected "
                             f"{EXPECTED_MIGRATION_LAUNCHES}")
    scenario0_equal("aware plan", rep, mig_rep, per_week + (
        "conv_targets", "conv_active", "conv_alloc", "conv_committed_cost"))
    out["aware"] = dict(scenarios=SCEN_AWARE_N, family="scale", wall_s=secs,
                        max_memory_allocated=peak, sweep_launches=launches,
                        scenario0_bit_for_bit=True)

    # 16 pools, N = 4 chunked by 3: against the unchunked run (bits) and
    # the CPU (costs within rel 1e-4, targets within one grid cell)
    sub = PoolSet(keys=pools.keys[:SCEN_CHUNK_POOLS],
                  demand=pools.demand[:SCEN_CHUNK_POOLS,
                                      :SCEN_CHUNK_WEEKS * 168],
                  configs=pools.configs[:SCEN_CHUNK_POOLS])
    kw = dict(solver="grid", num_grid=NUM_GRID, start_weeks=SCEN_CHUNK_START)
    full_cfg = ScenarioConfig(n_scenarios=SCEN_CHUNK_N, family="growth")
    chunk_cfg = ScenarioConfig(n_scenarios=SCEN_CHUNK_N, family="growth",
                               chunk=SCEN_CHUNK)
    chunked = replan_fleet_pools(sub, scenarios=chunk_cfg, **kw)
    full = replan_fleet_pools(sub, scenarios=full_cfg, **kw)
    for name in per_week + ("one_shot_weekly_cost", "hindsight_weekly_cost",
                            "hindsight_widths", "scenario_cost",
                            "scenario_cr", "scenario_one_shot_cost"):
        bits_equal(f"chunked {name}", getattr(chunked, name),
                   getattr(full, name))
    if chunked.total_cost != full.total_cost:
        raise AssertionError("chunked total differs from unchunked")
    t0 = time.perf_counter()
    cpu = replan_fleet_pools(sub, scenarios=chunk_cfg, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    cost_rel = float(np.max(np.abs(chunked.scenario_cost - cpu.scenario_cost)
                            / cpu.scenario_cost))
    if cost_rel > 1e-4:
        raise AssertionError(f"chunked card vs CPU scenario costs {cost_rel}")
    t_hist = (sub.num_hours // 168) * 168
    rows = sc.scenario_batch(sub.demand[:, :t_hist], chunk_cfg,
                             device="cpu").reshape(-1, t_hist)
    cells = grid_cells(sub, cpu, NUM_GRID, demand=rows).reshape(
        len(cpu.weeks), SCEN_CHUNK_N, SCEN_CHUNK_POOLS)[..., None]
    diff = np.abs(chunked.targets - cpu.targets)
    if (diff > cells * (1.0 + (NUM_GRID - 1) * 1e-4)).any():
        raise AssertionError("chunked card vs CPU targets differ by more "
                             f"than one cell ({float((diff / cells).max())})")
    out["chunked_16"] = dict(
        pools=SCEN_CHUNK_POOLS, weeks=SCEN_CHUNK_WEEKS,
        start_weeks=SCEN_CHUNK_START, scenarios=SCEN_CHUNK_N,
        chunk=SCEN_CHUNK,
        chunked_equals_unchunked=True, card_vs_cpu_cost_rel=cost_rel,
        card_vs_cpu_max_target_cells=float((diff / cells).max()),
        cpu_wall_s=cpu_s)
    emit("scenarios", pools=NUM_POOLS, hours=NUM_HOURS, nvidia_smi=smi(),
         **out)
    return out["grid_plan"]["sweep_launches"]


def phase_tournament(dev):
    """run_tournament at the reference's defaults on the card (every
    registry policy, 5 families x 32 seeds x 3 pools x 48 weeks, the
    (F*N*P) rows of one replay per policy), against the CPU on the same
    paths (each path's bill within TOURNAMENT_RTOL) and the scan backend
    against the loop backend (TOURNAMENT_LOOP_RTOL)."""
    from repro_torch.capacity import pricing
    from repro_torch.core import forecast as fc
    from repro_torch.core import policy as pol
    from repro_torch.core import portfolio as pf
    from repro_torch.core import tournament as tn
    from repro_torch.data import scenarios as sc
    names = list(pol.POLICIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = tn.run_tournament(names, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    paths = np.stack([sc.scenario_paths(f, num_pools=3, num_weeks=48,
                                        num_seeds=32)
                      for f in sc.FAMILIES])
    kw = dict(start_weeks=20, cadence_weeks=2, horizon_weeks=8,
              options=pf.options_from_pricing(),
              od=pricing.on_demand_premium(), cfg=fc.ForecastConfig())
    t0 = time.perf_counter()
    cpu = tn._run_on_paths([pol.get_policy(p) for p in names], sc.FAMILIES,
                           paths, backend="scan", device=torch.device("cpu"),
                           **kw)
    cpu_s = time.perf_counter() - t0
    loop = tn._run_on_paths([pol.get_policy(p) for p in names], sc.FAMILIES,
                            paths, backend="loop", device=dev, **kw)
    rel = {
        "card_vs_cpu": float(np.max(np.abs(card.cost / cpu.cost - 1.0))),
        "card_vs_cpu_hindsight": float(np.max(np.abs(
            card.hindsight_cost / cpu.hindsight_cost - 1.0))),
        "scan_vs_loop": float(np.max(np.abs(card.cost / loop.cost - 1.0))),
    }
    if (max(rel["card_vs_cpu"], rel["card_vs_cpu_hindsight"])
            > TOURNAMENT_RTOL or rel["scan_vs_loop"] > TOURNAMENT_LOOP_RTOL):
        raise AssertionError(f"tournament disagreement: {rel}")
    if not np.isfinite(card.competitive_ratio).all():
        raise AssertionError("tournament: non-finite ratios")
    sharded_dir().mkdir(parents=True, exist_ok=True)
    np.savez(sharded_dir() / "tournament.npz", cost=card.cost,
             hindsight=card.hindsight_cost)
    emit("tournament", policies=names, families=list(sc.FAMILIES),
         seeds=card.num_seeds, pools=3, weeks=48, wall_s=secs,
         cpu_wall_s=cpu_s, rel=rel,
         cr_mean={p: {f: card.family_stats(p, f)["cr_mean"]
                      for f in card.families} for p in card.policies},
         cr_min=float(card.competitive_ratio.min()))


def sharded_dir() -> Path:
    return ROOT / "build" / "chip_smoke" / "sharded"


def report_values(rep) -> dict:
    """Every array and number of a report, by field name (the ladders and
    other objects aside)."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if isinstance(v, np.ndarray) or (isinstance(v, (int, float))
                                         and not isinstance(v, bool)):
            out[f.name] = np.asarray(v)
    return out


def same_bits(name, got, want):
    """Raise unless two tensors hold the same bits (and shape, dtype)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    a = got.contiguous().view(ints.get(got.element_size(), got.dtype))
    b = want.contiguous().view(ints.get(want.element_size(), want.dtype))
    if not torch.equal(a, b.to(a.device)):
        raise AssertionError(f"{name}: not bit for bit")


def sharded_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get(SHARDED_ARCH),
                               num_layers=SHARDED_LAYERS)


def elastic_state(cfg, dev) -> dict:
    """stablelm's params and an AdamW state (float32 master, m and v, the
    step) drawn from a generator seeded SHARDED_SEED on ``dev``: the same
    bits in every process."""
    from repro_torch.models.model import build
    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    params = {n: p.detach() for n, p in
              build(cfg, device=dev).init(gen).named_parameters()}
    return {"params": params, "opt": {
        "master": {n: p.float() for n, p in params.items()},
        "m": {n: 1e-3 * torch.randn(p.shape, generator=gen, device=dev)
              for n, p in params.items()},
        "v": {n: 1e-6 * torch.rand(p.shape, generator=gen, device=dev)
              for n, p in params.items()},
        "step": torch.tensor(7, dtype=torch.int32)}}


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def dryrun_device_bytes(cfg) -> dict:
    """The dry run's per-device parameter and AdamW bytes of ``cfg`` on
    SHARDED_MESH under the train rules (launch/cells.py, what
    launch/dryrun.py reports as params_bytes and opt_state_bytes)."""
    from repro_torch.launch.cells import Cell, cell_rules
    from repro_torch.models.config import SHAPES
    from repro_torch.models.model import build
    cell = Cell(arch=SHARDED_ARCH, shape="train_4k", cfg=cfg,
                cell=SHAPES["train_4k"], model=build(cfg, device="meta"))
    return cell.device_bytes(SHARDED_MESH, cell_rules(cell, SHARDED_MESH))


def sharded_rank(rank: int, out_dir: str, dev=None) -> int:
    """One rank of phase sharded (``chip_smoke.py --sharded-rank R DIR``):
    the 32-future grid plan and the tournament sharded over the ranks, the
    elastic restore of the parent's world-1 checkpoint onto {"data": 2}
    and a save of the placed state; writes ``rank<R>.json`` to DIR."""
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import policy as pol
    from repro_torch.core import replan as rp
    from repro_torch.core import tournament as tn
    from repro_torch.core.api import (
        PlanRequest, RollingConfig, ScenarioConfig, plan)
    from repro_torch.data import traces
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import build
    from repro_torch.sharding import placement
    from repro_torch.sharding.rules import TRAIN_RULES
    from repro_torch.train.optimizer import opt_state_shardings
    out_dir = Path(out_dir)
    t_start = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    torch.cuda.set_device(0)
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv",
                            rank=rank, world_size=SHARDED_WORLD)
    res = {"rank": rank}

    # the exchange, timed and sized around the port's own functions
    ex = {"s": 0.0, "gathered_bytes": 0, "sent_bytes": 0}
    gather_reports, gather_rows = rp._gather_scenario_reports, \
        mesh_mod.gather_rows

    def timed_gather(local, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather_reports(local, n)
        ex["s"] += time.perf_counter() - t0
        return out

    def sized_rows(local, n, *, axis=0):
        out = gather_rows(local, n, axis=axis)
        ex["gathered_bytes"] += out.nbytes
        ex["sent_bytes"] += np.asarray(local).nbytes
        return out

    rp._gather_scenario_reports = timed_gather
    mesh_mod.gather_rows = sized_rows
    try:
        # (a) the 32-future grid plan, 16 futures a rank
        pools = traces.synthetic_pool_set(num_pools=NUM_POOLS,
                                          num_hours=NUM_HOURS, seed=0)
        req = PlanRequest(pools=pools, mode="rolling", rolling=RollingConfig(
            solver="grid", num_grid=NUM_GRID), scenarios=ScenarioConfig(
                n_scenarios=SCEN_N, family="regime"))
        rep, plan_s, launches, plan_peak = timed(
            lambda: plan(req, device=dev), "commitment_sweep")
        if launches != EXPECTED_LAUNCHES:
            raise AssertionError(f"rank {rank}: {launches} sweep launches, "
                                 f"expected {EXPECTED_LAUNCHES}")
        want = np.load(out_dir / "scenarios.npz")
        got = report_values(rep)
        if set(got) != set(want.files):
            raise AssertionError(f"report fields {sorted(got)} vs "
                                 f"{sorted(want.files)}")
        for name in want.files:
            bits_equal(f"rank {rank} {name}", got[name], want[name])
        res.update(plan_wall_s=plan_s, plan_max_memory_allocated=plan_peak,
                   sweep_launches=launches,
                   scenarios=list(mesh_mod.shard_rows(SCEN_N)),
                   fields_bit_for_bit=len(want.files),
                   exchange_s=ex["s"],
                   exchange_gathered_bytes=ex["gathered_bytes"],
                   exchange_sent_bytes=ex["sent_bytes"])
        del rep, got, want, pools

        # (b) the tournament at its defaults
        ex.update(gathered_bytes=0, sent_bytes=0)
        tour, tour_s, _, tour_peak = timed(
            lambda: tn.run_tournament(list(pol.POLICIES), device=dev),
            "commitment_sweep")
        want = np.load(out_dir / "tournament.npz")
        bits_equal(f"rank {rank} tournament cost", tour.cost, want["cost"])
        bits_equal(f"rank {rank} tournament hindsight",
                   tour.hindsight_cost, want["hindsight"])
        res.update(tournament_wall_s=tour_s,
                   tournament_max_memory_allocated=tour_peak,
                   tournament_paths=list(mesh_mod.shard_rows(
                       tour.cost.shape[1] * tour.cost.shape[2])),
                   tournament_exchange_bytes=ex["gathered_bytes"])
    finally:
        rp._gather_scenario_reports = gather_reports
        mesh_mod.gather_rows = gather_rows

    # (c) the elastic round trip on {"data": 2}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = sharded_cfg()
    mesh = mesh_mod.make_mesh(SHARDED_MESH, device=dev)
    psh = build(cfg, device="meta").param_shardings(mesh, TRAIN_RULES)
    sh = {"params": psh, "opt": opt_state_shardings(psh)}
    full = elastic_state(cfg, dev)
    target = {"params": {n: t.to("meta") for n, t in
                         full["params"].items()},
              "opt": {k: ({n: t.to("meta") for n, t in v.items()}
                          if isinstance(v, dict) else torch.zeros_like(v))
                      for k, v in full["opt"].items()}}
    got, meta = CheckpointManager(str(out_dir / "ckpt1")).restore(
        1, target, shardings=sh)
    if meta != {"world": 1}:
        raise AssertionError(f"rank {rank}: restored metadata {meta}")
    restore_s = time.perf_counter() - t0
    local = {"params": 0, "opt_state": 0}
    for (name, g), (_, f) in zip(flat_leaves(got), flat_leaves(full)):
        if placement.is_placed(g):
            want_local = placement.local_slice(f, mesh, g.placements)
            same_bits(f"rank {rank} {name}", g.to_local(), want_local)
            kind = "params" if name.startswith("params.") else "opt_state"
            local[kind] += g.to_local().numel() * g.to_local().element_size()
        else:
            same_bits(f"rank {rank} {name}", g, f)
    dry = dryrun_device_bytes(cfg)
    for kind in ("params", "opt_state"):
        if local[kind] != dry[kind]:
            raise AssertionError(f"rank {rank}: {kind} {local[kind]} bytes "
                                 f"placed, the dry run counts {dry[kind]}")
    del got
    t1 = time.perf_counter()
    CheckpointManager(str(out_dir / "ckpt2")).save(
        1, placement.place(full, sh), metadata={"world": SHARDED_WORLD})
    torch.cuda.synchronize()
    res.update(elastic=dict(
        layers=SHARDED_LAYERS, restore_s=restore_s,
        save_s=time.perf_counter() - t1, local_bytes=local,
        dryrun_bytes=dry, leaves=sum(1 for _ in flat_leaves(full))),
        wall_s=time.perf_counter() - t_start,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def phase_sharded(dev):
    """Phase sharded: the parent's world-1 checkpoint, two rank processes
    on the one card (:func:`sharded_rank`), then the ranks' checkpoint
    restored here at world 1; returns the sweep launches of each rank."""
    import shutil

    from repro_torch.ckpt.manager import CheckpointManager
    out_dir = sharded_dir()
    for name in ("ckpt1", "ckpt2"):
        shutil.rmtree(out_dir / name, ignore_errors=True)
    for name in ["rdv"] + [f"rank{r}.json" for r in range(SHARDED_WORLD)]:
        (out_dir / name).unlink(missing_ok=True)
    cfg = sharded_cfg()
    t0 = time.perf_counter()
    state = elastic_state(cfg, dev)
    CheckpointManager(str(out_dir / "ckpt1")).save(1, state,
                                                   metadata={"world": 1})
    save1_s = time.perf_counter() - t0
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         str(r), str(out_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SHARDED_WORLD)]
    try:
        outs = [p.communicate(timeout=SHARDED_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    spawn_s = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{err[-6000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_WORLD)]
    t0 = time.perf_counter()
    want = elastic_state(cfg, dev)
    got, meta = CheckpointManager(str(out_dir / "ckpt2")).restore(1, want)
    if meta != {"world": SHARDED_WORLD}:
        raise AssertionError(f"restored metadata {meta}")
    for (name, g), (_, w) in zip(flat_leaves(got), flat_leaves(want)):
        same_bits(f"world-1 restore {name}", g, w)
    restore2_s = time.perf_counter() - t0
    del got, want
    for name in ("ckpt1", "ckpt2"):
        shutil.rmtree(out_dir / name, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("sharded", world=SHARDED_WORLD, nvidia_smi=smi(),
         ranks_share_one_card=True, ranks=ranks, ranks_wall_s=spawn_s,
         parent_save_s=save1_s, parent_restore_s=restore2_s,
         elastic_arch=SHARDED_ARCH, elastic_layers=SHARDED_LAYERS,
         mesh=SHARDED_MESH, plan_bit_for_bit=True,
         tournament_bit_for_bit=True, elastic_bit_for_bit=True)
    return [r["sweep_launches"] for r in ranks]


def breach_oracle(demand, lo_all, hi_all, start, band=(0.05, 0.95),
                  tolerance=4.0):
    """The breach decision mask replayed on the host by a python loop over
    the emitted bands (S, P): integer hour counts against the integer
    budgets, the whole fleet deciding when any pool breaches."""
    q_lo, q_hi = band
    allow_above = int(tolerance * (1.0 - q_hi) * 168)
    allow_below = int(tolerance * q_lo * 168)
    demand = np.asarray(demand)
    demand = demand[:, :demand.shape[1] // 168 * 168].reshape(
        demand.shape[0], -1, 168)
    lo = np.zeros(demand.shape[0], np.float32)
    hi = np.zeros(demand.shape[0], np.float32)
    want = np.zeros(lo_all.shape[0], bool)
    for i in range(lo_all.shape[0]):
        w = start + i
        d_prev = demand[:, w - 1]
        above = (d_prev > hi[:, None]).sum(-1)
        below = (d_prev < lo[:, None]).sum(-1)
        want[i] = bool(((above > allow_above) | (below > allow_below)).any()
                       or w == start)
        if want[i]:
            lo, hi = lo_all[i], hi_all[i]
    return want


def phase_telemetry(pools, grid_rep):
    """Telemetry, the breach cadence and the carried IRLS moments on the
    main fleet at phase plan's settings (a main path, launches counted
    from 0 around each plan): the plain plan again (time, host syncs); the
    plan with TelemetryConfig(calibration=True, provenance=True), bit for
    bit phase plan's report, its ledger reconciled, its kernel stats the
    shape of every sweep launch, the calibration coverage, the decision
    log's holdings against the carried stack; the breach plan (234
    launches, its mask against the host oracle over its bands, host syncs
    no more than the weekly plan's, the bill pinned as BREACH_BILL); the
    carried moments against the exact irls_iters=1 plan; N = 32 regime
    futures under breach with calibration; breach, calibration,
    provenance and carry together on 16 pools, card vs CPU; and the
    tournament with a span recorder timed by CUDA events."""
    from repro_torch import obs
    from repro_torch.core import policy as pol
    from repro_torch.core import tournament as tn
    from repro_torch.core.api import (PlanRequest, RollingConfig,
                                      ScenarioConfig, plan)
    from repro_torch.core.demand import PoolSet
    from repro_torch.core.replan import replan_fleet_pools
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    grid = dict(solver="grid", num_grid=NUM_GRID)
    tele = obs.TelemetryConfig(calibration=True, provenance=True)
    per_week = ("targets", "increments", "active", "committed_cost",
                "on_demand_cost", "utilization", "one_shot_weekly_cost",
                "hindsight_weekly_cost", "decision_mask")
    bills = ("total_cost", "one_shot_cost", "hindsight_cost")
    out = {}

    def request(**kw):
        rolling = {k: kw.pop(k) for k in list(kw)
                   if k in RollingConfig.__dataclass_fields__}
        return PlanRequest(pools=kw.pop("pools", pools), mode="rolling",
                           rolling=RollingConfig(**grid, **rolling), **kw)

    # The plain plan again, in this phase: its time and host syncs.
    (plain, plain_syncs), plain_s, launches, _ = timed(
        lambda: count_syncs(lambda: plan(request())), "commitment_sweep")
    for name in per_week + ("hindsight_widths",):
        bits_equal(f"plain plan {name}", getattr(plain, name),
                   getattr(grid_rep, name))

    # Telemetry on, recording the shape of every sweep launch.
    shapes, launch = [], ck.commitment_sweep_cuda

    def recording(f, w, cs):
        shapes.append((f.shape[0], cs.shape[1], f.shape[1]))
        return launch(f, w, cs)

    ck.commitment_sweep_cuda = recording
    try:
        (rep, tele_syncs), secs, tele_launches, peak = timed(
            lambda: count_syncs(lambda: plan(request(telemetry=tele))),
            "commitment_sweep")
    finally:
        ck.commitment_sweep_cuda = launch
    if tele_launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{tele_launches} sweep launches with "
                             "telemetry")
    for name in per_week + ("hindsight_widths",):
        bits_equal(f"telemetry plan {name}", getattr(rep, name),
                   getattr(grid_rep, name))
    bits_equal("telemetry plan weekly_cost", rep.weekly_cost,
               grid_rep.weekly_cost)
    for name in bills:
        if getattr(rep, name) != getattr(grid_rep, name):
            raise AssertionError(f"telemetry moved {name}")
    ks = rep.kernel_stats
    if (len(shapes) != tele_launches
            or any(sh != (ks.p, ks.g, ks.t) for sh in shapes)
            or (ks.p, ks.g, ks.t) != (MAIN_P, MAIN_G, MAIN_T)):
        raise AssertionError(f"kernel stats {ks} against launches "
                             f"{sorted(set(shapes))} x {len(shapes)}")
    recon = rep.ledger.reconcile(rep)
    if not recon["ok"]:
        raise AssertionError(f"ledger does not reconcile: {recon}")
    log, cube = rep.decision_log, rep.calibration
    for i in PROVENANCE_WEEKS:
        held = log.holdings(int(log.weeks[i]))
        rebuilt = np.asarray([sum(t["width"] for t in held[e])
                              for e in log.entities])
        np.testing.assert_allclose(rebuilt, rep.active[i].sum(-1),
                                   rtol=1e-5, atol=1e-4)
    if not (np.isfinite(cube.pinball).all()
            and cube.levels.shape == (len(rep.weeks), 1, NUM_POOLS, 5)):
        raise AssertionError("calibration cube malformed")
    out["telemetry_plan"] = dict(
        wall_s=secs, plain_wall_s=plain_s, telemetry_cost_s=secs - plain_s,
        host_syncs=tele_syncs, plain_host_syncs=plain_syncs,
        max_memory_allocated=peak, sweep_launches=tele_launches,
        bit_for_bit_with_plan=True, kernel_stats=ks.to_dict(),
        ledger_total=rep.ledger.total, reconcile_max_rel=recon["max_rel"],
        unit_economics=rep.ledger.unit_economics(),
        coverage={str(q): float(c) for q, c in zip(cube.fractiles,
                                                   cube.coverage())},
        max_coverage_drift=cube.max_coverage_drift,
        binding_counts=log.binding_counts(),
        holdings_match_active_weeks=[int(log.weeks[i])
                                     for i in PROVENANCE_WEEKS])
    del rep, log, cube

    # The breach cadence on the same fleet.
    (brep, syncs), secs, launches, peak = timed(
        lambda: count_syncs(lambda: plan(request(cadence="breach"))),
        "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the breach plan")
    oracle = breach_oracle(pools.demand, brep.breach_band_lo,
                           brep.breach_band_hi, brep.start_weeks)
    bits_equal("breach mask vs host oracle", brep.decision_mask, oracle)
    if syncs > plain_syncs:
        raise AssertionError(f"breach plan {syncs} host syncs, weekly "
                             f"{plain_syncs}")
    breach_costs = {k: getattr(brep, k) for k in bills}
    breach_rel = {k: abs(breach_costs[k] - v) / v
                  for k, v in BREACH_BILL.items()}
    if max(breach_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the breach plan's bill moved: {breach_rel}")
    out["breach_plan"] = dict(
        wall_s=secs, max_memory_allocated=peak, sweep_launches=launches,
        decision_weeks=int(brep.decision_mask.sum()),
        weekly_decision_weeks=int(grid_rep.decision_mask.sum()),
        bill_vs_weekly_rel=(brep.total_cost / grid_rep.total_cost - 1.0),
        host_syncs=syncs, weekly_host_syncs=plain_syncs,
        mask_equals_oracle=True, bill=breach_costs, bill_rel=breach_rel)

    # The carried IRLS moments against the exact irls_iters=1 refits.
    exact, exact_s, _, _ = timed(
        lambda: plan(request(irls_iters=1, compare=False)),
        "commitment_sweep")
    carry, carry_s, carry_launches, _ = timed(
        lambda: plan(request(irls_iters=1, irls_carry=True, compare=False)),
        "commitment_sweep")
    rel = abs(carry.total_cost - exact.total_cost) / exact.total_cost
    rel_base = abs(grid_rep.total_cost - exact.total_cost) / exact.total_cost
    if not (rel < CARRY_RTOL and rel < rel_base):
        raise AssertionError(f"carried moments {rel} from the exact refit "
                             f"(irls_iters=0: {rel_base})")
    out["irls_carry"] = dict(
        carry_wall_s=carry_s, exact_wall_s=exact_s,
        sweep_launches=carry_launches, carry_total=carry.total_cost,
        exact_total=exact.total_cost, carry_vs_exact_rel=rel,
        base_vs_exact_rel=rel_base)
    del exact, carry

    # N = 32 regime futures under the breach cadence with calibration.
    srep, secs, launches, peak = timed(
        lambda: plan(request(cadence="breach", telemetry=obs.TelemetryConfig(
            ledger=False, kernel_stats=False, calibration=True),
            scenarios=ScenarioConfig(n_scenarios=TELEMETRY_SCEN_N,
                                     family="regime"))),
        "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the breach "
                             "scenario plan")
    scenario0_equal("breach scenario plan", srep, brep,
                    per_week + ("breach_band_lo", "breach_band_hi"))
    mask = srep.decision_mask
    if (mask.shape != (len(srep.weeks), TELEMETRY_SCEN_N)
            or srep.calibration.n_scenarios != TELEMETRY_SCEN_N):
        raise AssertionError("per-scenario masks or the cube malformed")
    out["breach_scenarios"] = dict(
        scenarios=TELEMETRY_SCEN_N, family="regime", wall_s=secs,
        max_memory_allocated=peak, sweep_launches=launches,
        scenario0_bit_for_bit=True,
        decision_weeks_per_scenario=mask.sum(0).tolist(),
        scenario_coverage_min=srep.calibration.scenario_coverage().min(
            0).tolist(),
        scenario_coverage_max=srep.calibration.scenario_coverage().max(
            0).tolist())
    del srep, brep

    # Breach, calibration, provenance and carry together on 16 pools.
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    kw = dict(grid, cadence="breach", irls_iters=1, irls_carry=True,
              telemetry=tele, compare=False)
    card = replan_fleet_pools(sub, **kw)
    t0 = time.perf_counter()
    cpu = replan_fleet_pools(sub, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    bits_equal("16 pools card vs CPU mask", card.decision_mask,
               cpu.decision_mask)
    for name in ("breach_band_lo", "breach_band_hi", "fractile_levels"):
        bits_equal(f"16 pools card vs CPU {name}", getattr(card, name),
                   getattr(cpu, name))
    bits_equal("16 pools card vs CPU calibration hits", card.calibration.hits,
               cpu.calibration.hits)
    rel16 = abs(card.total_cost - cpu.total_cost) / cpu.total_cost
    if rel16 > CARD_CPU_RTOL:
        raise AssertionError(f"16 pools card vs CPU bill {rel16}")
    out["card_vs_cpu_16"] = dict(
        total_rel=rel16, masks_bands_levels_hits_equal=True,
        cpu_wall_s=cpu_s, decision_weeks=int(card.decision_mask.sum()),
        ledger_rel=abs(card.ledger.total / cpu.ledger.total - 1.0),
        pinball_max_diff_of_scale=float(
            np.abs(card.calibration.pinball - cpu.calibration.pinball).max()
            / np.abs(cpu.calibration.pinball).max()))

    # The tournament with a span recorder on the card (CUDA events).
    rec = obs.SpanRecorder()
    names = list(pol.POLICIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tn.run_tournament(names, spans=rec)
    summary = rec.summary()
    host_s = time.perf_counter() - t0
    want = {f"tournament/{n}" for n in names} | {"tournament/hindsight"}
    if set(summary) != want or not all(v["total_s"] > 0
                                       for v in summary.values()):
        raise AssertionError(f"tournament spans: {summary}")
    out["tournament_spans"] = dict(
        timer=rec.timer, wall_s=host_s, device_s=rec.total_s,
        by_span={k: v["total_s"] for k, v in summary.items()})
    emit("telemetry", pools=NUM_POOLS, hours=NUM_HOURS, nvidia_smi=smi(),
         **out)
    return tele_launches


def device_kernels(prof):
    """(device us, count, name) of every device-side event (kernels,
    memcpys, memsets), largest first: the aten ops on the host side carry
    their kernels' time too and would count twice; the profiler's own
    buffer events are not the program's work, and the port's annotated
    ranges (ANNOTATIONS), which the profiler also draws on the device's
    timeline, span kernels already counted."""
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if (dev_us > 0 and on_device and "Buffer" not in ev.key
                and ev.key not in ANNOTATIONS):
            kernels.append((dev_us, ev.count, ev.key))
    return sorted(kernels, reverse=True)


def profiled(fn):
    """fn() once under torch.profiler: (summary, kernels), the summary
    the profiled wall seconds, device busy seconds and events and the top
    device kernels (ms, count, name); kernels as device_kernels gives
    them.  CUDA activity only: the host-side op events add nothing to the
    device time and multiply both the profiled wall time and the time to
    process the trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    busy = sum(k[0] for k in kernels) / 1e6
    return dict(profiled_wall_s=wall, device_busy_s=busy,
                device_events=sum(n for _, n, _ in kernels),
                device_busy_share_of_profiled=busy / wall,
                top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                             for us, n, key in kernels[:8]]), kernels


def fleet_rel(card, cpu, keys):
    """Largest gap over ``keys`` of two plans' costs, each as a share of
    its own bill, the committed and on-demand parts as a share of the
    plan's total."""
    def bill(k):
        part = k in ("committed_cost", "on_demand_cost")
        return abs(getattr(cpu, "total_cost" if part else k))
    return max(abs(getattr(card, k) - getattr(cpu, k)) / bill(k)
               for k in keys)


def sec4_rows(dev):
    """Paper §4 on the port's own 52-week trace: the level on ``dev``, the
    trough supply and the EDF schedule (host numpy), and shift_demand's
    conservation on ``dev`` (at the level, and at an over-full budget)."""
    from repro_torch.core import commitment as cm
    from repro_torch.core import demand as dm
    from repro_torch.core import timeshift as ts
    f = dm.synth_demand(SEC4_WEEKS * 168, generator=torch.Generator(
        ).manual_seed(SEC4_SEED))
    c = float(cm.optimal_commitment_quantile(f.to(dev)))
    fn = f.numpy()
    stats = ts.shiftable_supply_stats(fn, c)
    work = fn.sum() * 0.05
    jobs = [ts.Job(arrival=int(h), work=float(work / SEC4_JOBS),
                   deadline=int(h) + 168)
            for h in np.linspace(0, len(fn) - 168 - 1, SEC4_JOBS)]
    out = ts.schedule_jobs(fn, c, jobs)
    conserve = {}
    for label, level, frac in (("at_level", c, 0.3),
                               ("overfull", float(fn.min()) + 0.5, 0.9)):
        g = ts.shift_demand(f.to(dev), level, frac).double().sum()
        conserve[label] = abs(float(g) / float(f.double().sum()) - 1.0)
    return dict(commitment=c, unused_frac=stats["unused_frac"],
                weekend_share=stats["weekend_share"],
                timeshift_od_saved_frac=out["on_demand_savings"]
                / max(out["on_demand_cost_naive"], 1e-9),
                on_demand_savings=out["on_demand_savings"],
                shift_conservation_rel=conserve)


def fig12(dev):
    """Paper Fig. 12 on the port's own draws: 8 weeks of history, the
    ninth week held out, p_over 1, p_under 10, lead time 1."""
    from repro_torch.core import demand as dm
    from repro_torch.core import freepool as fp
    gen = torch.Generator().manual_seed(FIG12_SEED)
    full = dm.synth_demand((FIG12_WEEKS + 1) * 168, generator=gen)
    cfg = fp.FreePoolConfig(p_over=1.0, p_under=10.0, lead_time=1)
    return fp.compare_static_vs_predicted(full[:-168], full[-168:], cfg,
                                          device=dev)


def phase_fleet_sim(dev):
    """The fleet simulator on the card: default_fleet (chips per replica
    held to FLEET_CHIPS), simulate_and_plan_pools() (2 sweep launches),
    simulate_and_replan_pools() with the default solver and with
    solver="grid" (2 sweep launches per replayed week: the rolling and the
    one-shot replay), the replan with demand_migration=True (1 turnover
    launch) and with spot=True, replayed by replay_spot_plan (1 walk
    launch); plan_fleet and plan_fleet_portfolio with shiftable_frac=0.3
    on the fleet total; the §4 rows on 52 weeks and Fig. 12 from the
    port's generator.  Each plan card against the CPU on the same traces
    within FLEET_CPU_RTOL, the bills against FLEET_BILL."""
    from repro_torch.capacity import simulator as sim
    t_phase = time.perf_counter()
    fleets, jobs = sim.default_fleet()
    chips = {f.arch: f.chips_per_replica for f in fleets}
    if chips != FLEET_CHIPS or len(sim.default_pool_catalog()) != 12:
        raise AssertionError(f"default fleet: {chips}")
    cpu = torch.device("cpu")
    walls, launches, rel, bills = {}, {}, {}, {}

    def run(label, counted, fn, keys):
        with warnings.catch_warnings():
            # the reference's loose cadence_weeks/solver keywords
            warnings.simplefilter("ignore", DeprecationWarning)
            (pools, card), walls[label], launches[label], _ = timed(
                lambda: fn(dev), counted)
            t0 = time.perf_counter()
            _, host = fn(cpu)
            walls[label + "_cpu"] = time.perf_counter() - t0
        rel[label] = fleet_rel(card, host, keys)
        bills[label] = {k: getattr(card, k) for k in keys}
        return pools, card

    one_keys = ("total_cost", "committed_cost", "on_demand_cost",
                "aggregate_cost")
    roll_keys = ("total_cost", "one_shot_cost", "hindsight_cost")
    pools, one = run("one_shot", "commitment_sweep",
                     lambda d: sim.simulate_and_plan_pools(device=d),
                     one_keys)
    _, roll = run("replan", "commitment_sweep",
                  lambda d: sim.simulate_and_replan_pools(device=d),
                  roll_keys)
    _, grid = run("replan_grid", "commitment_sweep",
                  lambda d: sim.simulate_and_replan_pools(
                      solver="grid", num_grid=NUM_GRID, device=d),
                  roll_keys)
    _, mig = run("replan_migration", "generation_turnover",
                 lambda d: sim.simulate_and_replan_pools(
                     demand_migration=True, device=d), roll_keys)
    spot_pools, spot = run("replan_spot", "commitment_sweep",
                           lambda d: sim.simulate_and_replan_pools(
                               spot=True, device=d), roll_keys)
    replay, walls["spot_replay"], launches["spot_replay"], _ = timed(
        lambda: sim.replay_spot_plan(spot_pools, spot), "revocation_walk")
    weeks = len(grid.weeks)
    if one.widths.shape[0] != pools.num_pools or pools.num_pools != 12:
        raise AssertionError("fleet_sim: the one-shot plan is not per pool")
    for label, b in bills.items():
        if not all(np.isfinite(v) and v > 0 for v in b.values()):
            raise AssertionError(f"fleet_sim {label}: bills {b}")
    if not (0 < one.total_cost < one.all_on_demand_cost):
        raise AssertionError("fleet_sim: the one-shot plan saves nothing")
    if abs(grid.total_cost / roll.total_cost - 1.0) > 0.02:
        raise AssertionError("fleet_sim: grid total 2% away from quantile")
    if not replay.meets_target:
        raise AssertionError("fleet_sim: the spot replay misses its target")

    demand = pools.aggregate().astype(np.float64)

    def fleet_plans(d):
        return (sim.plan_fleet(demand, shiftable_frac=0.3, device=d),
                sim.plan_fleet_portfolio(demand, shiftable_frac=0.3,
                                         device=d))
    (single, port), walls["plan_fleet"], launches["plan_fleet"], _ = timed(
        lambda: fleet_plans(dev), "commitment_sweep")
    single_cpu, port_cpu = fleet_plans(cpu)
    plan_keys = ("total_cost", "committed_cost", "on_demand_cost",
                 "all_on_demand_cost")
    rel["plan_fleet"] = fleet_rel(single, single_cpu, plan_keys)
    rel["plan_fleet_portfolio"] = fleet_rel(
        port, port_cpu, plan_keys + ("single_level_cost",))
    if not (port.total_cost < port.all_on_demand_cost
            and single.total_cost < single.all_on_demand_cost):
        raise AssertionError("fleet_sim: a fleet-total plan saves nothing")

    sec4, walls["sec4"], _, _ = timed(lambda: sec4_rows(dev),
                                      "commitment_sweep")
    sec4_cpu = sec4_rows(cpu)
    shift_rel = max(*sec4["shift_conservation_rel"].values(),
                    *sec4_cpu["shift_conservation_rel"].values())
    if shift_rel > FLEET_SHIFT_RTOL or sec4["on_demand_savings"] < 0:
        raise AssertionError(f"§4: {sec4}")
    rel["sec4_commitment"] = abs(sec4["commitment"]
                                 / sec4_cpu["commitment"] - 1.0)
    f12, walls["fig12"], _, _ = timed(lambda: fig12(dev), "commitment_sweep")
    f12_cpu = fig12(cpu)
    rel["fig12"] = max(abs(f12[k] / f12_cpu[k] - 1.0) for k in (
        "static_cost", "predicted_cost", "predicted_mean_size"))
    if not f12["predicted_cost"] < f12["static_cost"]:
        raise AssertionError(f"Fig. 12: {f12}")
    if max(rel.values()) > FLEET_CPU_RTOL:
        raise AssertionError(f"fleet_sim card vs CPU: {rel}")
    bill_rel = {
        f"{label}.{k}": abs(bills[label][k] - v) / v
        for label, pinned in FLEET_BILL.items() for k, v in pinned.items()}
    emit("fleet_sim", pools=pools.num_pools, hours=pools.num_hours,
         one_shot_hours=24 * 7 * 40, replan_hours=24 * 7 * 60,
         weeks_replayed=weeks, chips_per_replica=chips, launches=launches,
         wall_s=walls, card_vs_cpu_rel=rel, bills=bills, bill_rel=bill_rel,
         spot_replay=dict(fleet_availability=replay.fleet_availability,
                          planned_cost=replay.planned_cost,
                          realized_cost=replay.realized_cost),
         plan_fleet=dict(commitment=single.commitment,
                         total_cost=single.total_cost,
                         savings_vs_on_demand=single.savings_vs_on_demand),
         plan_fleet_portfolio=dict(
             total_cost=port.total_cost, breakdown=port.breakdown,
             savings_vs_single_level=port.savings_vs_single_level),
         sec4=sec4, fig12=dict(f12, cost_reduction=1.0 - f12[
             "predicted_cost"] / f12["static_cost"], under_minutes_ratio=f12[
             "under_minutes_predicted"] / max(f12["under_minutes_static"],
                                              1e-9)),
         phase_s=time.perf_counter() - t_phase)
    # checked after the line is printed, so a failing run shows them all
    want = {"one_shot": FLEET_ONE_SHOT_LAUNCHES, "replan": 0,
            "replan_grid": 2 * weeks, "replan_migration": 1,
            "replan_spot": 0, "spot_replay": 1, "plan_fleet": 1}
    if launches != want:
        raise AssertionError(f"fleet_sim launches {launches}, expected {want}")
    if FLEET_BILL.keys() != {"one_shot", "replan", "replan_grid",
                             "replan_migration", "replan_spot"} or (
            max(bill_rel.values()) > BILL_RTOL):
        raise AssertionError(f"the fleet's bills moved: {bill_rel}")
    return launches


def phase_profile(pools, rep, plan_s):
    """Where the plan's time goes: the grid plan again under
    torch.profiler (device time by kernel, device busy share), and the
    host-side tranche book timed alone on the plan's own targets."""
    from repro_torch.core import ladder as ld
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    summary, kernels = profiled(lambda: plan(req))
    prof_s, busy_s = summary["profiled_wall_s"], summary["device_busy_s"]
    sweep_s = sum(k[0] for k in kernels if "sweep_kernel" in k[2]) / 1e6
    lines = [f"{us / 1e3:12.3f} ms {n:8d}x  {key}" for us, n, key in kernels]
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_grid_plan.txt").write_text(
        f"{torch.cuda.get_device_name(0)}, {smi()}\n"
        f"profiled plan wall {prof_s:.3f} s, device busy {busy_s:.3f} s\n"
        + "\n".join(lines) + "\n")
    # the tranche book the replay builds after its loop, alone
    weeks, k = rep.weeks, len(rep.options)
    dec = rep.decision_mask
    full = np.zeros((NUM_POOLS, weeks[-1] + 1, k), np.float32)
    full[:, weeks[dec]] = np.swapaxes(rep.targets[dec], 0, 1)
    terms = np.asarray([o.term_weeks * 168 for o in rep.options])
    t0 = time.perf_counter()
    ld.plan_pool_portfolio_purchases(full, terms, rep.keys)
    ladder_s = time.perf_counter() - t0
    emit("profile", solver="grid", plan_wall_s=plan_s,
         sweep_device_s=sweep_s, ladder_book_host_s=ladder_s, **summary)
    return summary


def median_ms(fn, reps, cover=True):
    """Median device milliseconds of fn() over reps runs, by CUDA events.
    With ``cover``, a spin kernel queued before the start event keeps the
    card busy while the host enqueues fn's launches, so the interval is the
    card's time for fn and not the host's dispatch (which would dominate a
    Python wrapper around a kernel of a few tens of microseconds); without
    it, on an idle card, the interval is one call's dispatch and run."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        if cover:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flash_inputs(dev, dtype, b, hq, hkv, sq, skv, d, seed, layout="bhsd",
                 dv=None):
    """q, k of head dim d and v of head dim dv (default d), normal."""
    gen = torch.Generator().manual_seed(seed)
    dv = d if dv is None else dv
    shape_q = (b, hq, sq, d) if layout == "bhsd" else (b, sq, hq, d)
    shape_kv = (b, hkv, skv, d) if layout == "bhsd" else (b, skv, hkv, d)
    shape_v = shape_kv[:3] + (dv,)
    return [torch.randn(s_, generator=gen).to(dev, dtype)
            for s_ in (shape_q, shape_kv, shape_v)]


def decode_inputs(dev, dtype=torch.bfloat16):
    """The batched decode's call: 8 slots, one query each, against the
    (B, S, H, D) cache, each slot with its own fill level."""
    b, h, d = FLASH_DECODE
    q, k, v = flash_inputs(dev, dtype, b, h, h, 1, SERVE_CACHE, d, 11,
                           layout="bshd")
    kv_len = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    return q, k, v, kv_len


def family_flash_inputs(dev, case, seed):
    """q, k, v (B, S, H, D) bf16 of a FLASH_FAMILIES case and its kv_len (a
    (B,) int32 tensor, or None for Skv)."""
    b, hq, hkv, sq, skv, d, _, lens = case
    q, k, v = flash_inputs(dev, torch.bfloat16, b, hq, hkv, sq, skv, d, seed,
                           layout="bshd")
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, lens


def flash_compare(name, got, want, tol):
    """Hold got to want (..., D) by ``tol``: element by element, and, where
    it names ``row``, each row's error norm against the row's norm.
    Returns the largest absolute error and the largest row ratio."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    elem = {k: tol[k] for k in ("atol", "rtol")}
    torch.testing.assert_close(got, want, **elem,
                               msg=lambda m: f"flash {name}: {m}")
    err, norm = (got - want).norm(dim=-1), want.norm(dim=-1)
    row = float((err / norm.clamp_min(torch.finfo(torch.float32).tiny)).max())
    if "row" in tol and not bool((err <= tol["row"] * norm).all()):
        raise AssertionError(f"flash {name}: a row's error is {row:.3g} of "
                             f"its norm, above {tol['row']}")
    return float((got - want).abs().max()), row


def flash_routed(fk, fn):
    """Run fn(); return its result and the one flash kernel it launched."""
    before = dict(fk.LAUNCHES_BY_KERNEL)
    out = fn()
    used = [k for k, n in fk.LAUNCHES_BY_KERNEL.items() if n != before[k]]
    if len(used) != 1 or fk.LAUNCHES_BY_KERNEL[used[0]] != before[used[0]] + 1:
        raise AssertionError(f"flash: one call launched {used}")
    return out, used[0]


def int8_cache(k, v):
    """The int8 cache of k, v (B, S, H, D), quantized as the model writes
    it, with one all-zero row (slot 2, position 5, kv head 1: the scale
    floor) and one row holding both +127 and -127 (slot 3, position 7, kv
    head 0): (k values, k scales, v values, v scales)."""
    from repro_torch.models.attention import _quantize_kv
    k, v = k.float().clone(), v.float().clone()
    k[2, 5, -1] = 0.0
    v[2, 5, -1] = 0.0
    k[3, 7, 0] = k[3, 7, 0].clamp(-1.0, 1.0)
    k[3, 7, 0, :2] = torch.tensor([2.0, -2.0], device=k.device)
    return (*_quantize_kv(k), *_quantize_kv(v))


def int8_decode_check(key, q, kq, ks, vq, vs, lens, tol):
    """One decode over the int8 cache (B, S, Hkv, D) through ops: it must
    launch decode_split's int8 instance (LAUNCHES_INT8), equal bit for bit
    decode_split's bf16/f32 instance on the same cache dequantized by
    torch, and lie within ``tol`` of the plain version.  Returns the
    largest error and the largest row ratio."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_int8_ref,
        dequantize_kv,
    )
    before = fk.LAUNCHES_INT8
    got, used = flash_routed(fk, lambda: ops.flash_attention(
        q, kq, vq, kv_len=lens, layout="bshd", k_scale=ks, v_scale=vs))
    if used != "decode_split" or fk.LAUNCHES_INT8 != before + 1:
        raise AssertionError(f"flash {key}: launched {used}, "
                             f"int8 {fk.LAUNCHES_INT8 - before}")
    kd, vd = dequantize_kv(kq, ks, q.dtype), dequantize_kv(vq, vs, q.dtype)
    same = ops.flash_attention(q, kd, vd, kv_len=lens, layout="bshd")
    torch.cuda.synchronize()
    if not torch.equal(got, same):
        raise AssertionError(
            f"flash {key}: the int8 instance != the {q.dtype} instance on "
            "the dequantized cache, "
            f"{float((got.float() - same.float()).abs().max())} apart")
    want = attention_int8_ref(
        *(x.transpose(1, 2) for x in (q, kq, vq, ks, vs)), causal=True,
        kv_len=lens)
    return flash_compare(key, got.transpose(1, 2), want, tol)


def int8_main_inputs(dev):
    """internlm2-20b's decode over an int8 cache (FLASH_INT8_DECODE
    against SERVE_CACHE, decode_inputs' fill levels up to the full
    cache): q, k, v in bf16, the cache quantized as the model writes it,
    and kv_len."""
    from repro_torch.models.attention import _quantize_kv
    b, hq, hkv, d = FLASH_INT8_DECODE
    q, k, v = flash_inputs(dev, torch.bfloat16, b, hq, hkv, 1, SERVE_CACHE,
                           d, 23, layout="bshd")
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return q, k, v, kq, ks, vq, vs, decode_inputs(dev)[3]


def flash_int8_cases(dev):
    """decode_split's int8 instance (int8_decode_check): 8 slots with
    FLASH_INT8_LENS over a cache of FLASH_INT8_CACHE, two kv heads in GQA
    groups 1, 4 and 6 at D 32, 64 and 128, q in bf16 and f32 (FLASH_BF16 /
    FLASH_F32), and serve_int8's own decode (int8_main_inputs).  Then a
    3-query decode over the int8 cache: dequantized first, on the kernel
    its shape routes to, no int8 launch.  Returns the errors, the row
    ratios and the routes."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_int8_ref
    errs, rows, routes = {}, {}, {}
    lens = torch.tensor(FLASH_INT8_LENS, dtype=torch.int32, device=dev)
    b, hkv, skv = len(FLASH_INT8_LENS), 2, FLASH_INT8_CACHE
    for i, (group, d) in enumerate(FLASH_INT8_CASES):
        for dtype, tol in ((torch.bfloat16, FLASH_BF16), (torch.float32,
                                                           FLASH_F32)):
            q, k, v = flash_inputs(dev, dtype, b, hkv * group, hkv, 1, skv,
                                   d, 90 + i, layout="bshd")
            kq, ks, vq, vs = int8_cache(k, v)
            if not (kq[3, 7, 0, 0] == 127 and kq[3, 7, 0, 1] == -127
                    and (kq[2, 5, -1] == 0).all()):
                raise AssertionError("flash int8: the cache's edge rows")
            key = f"int8_g{group}_d{d}_{str(dtype)[6:]}"
            errs[key], rows[key] = int8_decode_check(key, q, kq, ks, vq, vs,
                                                     lens, tol)
            routes[key] = "decode_split_int8"
    q, _, _, kq, ks, vq, vs, kv_len = int8_main_inputs(dev)
    key = "int8_internlm2_decode_bfloat16"
    errs[key], rows[key] = int8_decode_check(key, q, kq, ks, vq, vs, kv_len,
                                             FLASH_BF16)
    routes[key] = "decode_split_int8"
    q, k, v = flash_inputs(dev, torch.bfloat16, b, 8, hkv, 3, skv, 128, 99,
                           layout="bshd")
    kq, ks, vq, vs = int8_cache(k, v)
    before = fk.LAUNCHES_INT8
    got, used = flash_routed(fk, lambda: ops.flash_attention(
        q, kq, vq, kv_len=lens.clamp(min=3), layout="bshd", k_scale=ks,
        v_scale=vs))
    if used != fk.route(torch.bfloat16, 128, 3) or fk.LAUNCHES_INT8 != before:
        raise AssertionError(f"flash int8 multi-query: launched {used}")
    want = attention_int8_ref(
        *(x.transpose(1, 2) for x in (q, kq, vq, ks, vs)), causal=True,
        kv_len=lens.clamp(min=3))
    key = "int8_three_queries_bfloat16"
    errs[key], rows[key] = flash_compare(key, got.transpose(1, 2), want,
                                         FLASH_BF16)
    routes[key] = used
    return errs, rows, routes


def phase_flash(dev):
    """Every flash kernel against the plain version: the ragged cases in
    f32 and bf16 and both layouts, each checked to have launched the
    kernel its route names (f32 prefill and bf16 D = 32 on simt, bf16
    D = 64/128 prefill on prefill_tc, one query on decode_split; MLA's
    (Dqk, Dv) = (192, 128) and (96, 64) on prefill_tc in bf16, one query
    too, and on simt in f32), then the prefill and decode main shapes and
    MLA's two prefill shapes (FLASH_MLA, bf16), the decode also against
    the split-KV algebra's plain version, then the int8 decode
    (flash_int8_cases).  Returns the largest error over all cases."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        attention_split_ref,
    )
    errs, rows, routes = {}, {}, {}
    vec_kv = torch.tensor([130, 200, 300], dtype=torch.int32)
    cases = {  # (b, hq, hkv, sq, skv, d, causal, kv_len)
        "mha_ragged": (2, 4, 4, 77, 77, 64, True, None),
        "gqa_ragged": (2, 8, 2, 200, 200, 64, True, None),
        "mqa_d128": (1, 8, 1, 64, 64, 128, True, None),
        "decode_one_query": (2, 4, 2, 1, 300, 64, True, None),
        "cross_d32": (1, 2, 2, 96, 160, 32, True, None),
        "noncausal": (2, 4, 2, 100, 150, 64, False, None),
        "padded_cache": (2, 8, 2, 3, 384, 64, True, 257),
        "d128_ragged": (1, 4, 4, 300, 300, 128, True, None),
        "vec_kv_len_prefill": (3, 4, 2, 130, 300, 64, True, vec_kv),
        "gqa8_decode_d128": (3, 16, 2, 1, 1000, 128, True,
                             torch.tensor([1, 513, 1000], dtype=torch.int32)),
        # 6 tiles of 128 keys at D = 64: wraps prefill_tc's 3-stage ring
        "ring_wrap_kv_len": (2, 8, 2, 520, 700, 64, True,
                             torch.tensor([611, 700], dtype=torch.int32)),
        # simt's tile seams (64 rows, 64 keys), GQA group 4: Sq and Skv
        # one past, one short of and 8 past a tile, kv_len below Skv
        "seam_65_d64": (1, 4, 1, 65, 65, 64, True, None),
        "seam_127_d32": (2, 8, 2, 127, 127, 32, True, None),
        "seam_200_d128": (1, 8, 2, 200, 200, 128, True, None),
        "seam_kv_len_190": (1, 4, 1, 127, 200, 64, True, 190),
        "seam_kv_len_d128": (1, 8, 2, 65, 127, 128, True,
                             torch.tensor([100], dtype=torch.int32)),
        "seam_kv_len_d32": (2, 4, 1, 200, 256, 32, True,
                            torch.tensor([230, 256], dtype=torch.int32)),
        "seam_noncausal": (1, 4, 1, 65, 200, 64, False, 127),
        # MLA's head dims (Dqk, Dv): ragged, tile seams, GQA, kv_len,
        # one query (no split decode at Dqk != Dv), prefill_tc's ring
        "mla192_ragged": (2, 4, 2, 300, 520, 192, True,
                          torch.tensor([400, 520], dtype=torch.int32), 128),
        "mla192_seam_65": (1, 4, 4, 65, 65, 192, True, None, 128),
        "mla192_one_query": (2, 4, 4, 1, 77, 192, True, None, 128),
        "mla96_ragged": (2, 4, 4, 77, 77, 96, True, None, 64),
        "mla96_kv_len": (2, 4, 2, 130, 300, 96, True,
                         torch.tensor([300, 250], dtype=torch.int32), 64),
        "mla96_one_query": (1, 4, 4, 1, 70, 96, True, None, 64),
        "mla96_ring_wrap": (1, 4, 4, 520, 700, 96, True, None, 64),
    }
    for i, (name, (b, hq, hkv, sq, skv, d, causal, kvl, *dv)) in enumerate(
            cases.items()):
        dv = dv[0] if dv else d
        kvl = kvl.to(dev) if isinstance(kvl, torch.Tensor) else kvl
        for dtype, tol in ((torch.float32, FLASH_F32),
                           (torch.bfloat16, FLASH_BF16)):
            for layout in ("bhsd", "bshd"):
                q, k, v = flash_inputs(dev, dtype, b, hq, hkv, sq, skv, d, i,
                                       layout, dv)
                got, used = flash_routed(fk, lambda: ops.flash_attention(
                    q, k, v, causal=causal, kv_len=kvl, layout=layout))
                want_route = fk.route(dtype, d, sq, dv=dv)
                if used != want_route:
                    raise AssertionError(f"flash {name}: launched {used}, "
                                         f"route {want_route}")
                if layout == "bshd":
                    q, k, v, got = (x.transpose(1, 2) for x in (q, k, v, got))
                want = attention_ref(q, k, v, causal=causal, kv_len=kvl)
                key = f"{name}_{str(dtype)[6:]}_{layout}"
                errs[key], rows[key] = flash_compare(key, got, want, tol)
                routes[key] = used
    b, h, s, d = FLASH_PREFILL
    for dtype, tol in ((torch.bfloat16, FLASH_BF16), (torch.float32,
                                                       FLASH_F32)):
        q, k, v = flash_inputs(dev, dtype, b, h, h, s, s, d, 20,
                               layout="bshd")
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=True, layout="bshd"))
        want = attention_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=True)
        key = f"prefill_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "prefill", got.transpose(1, 2), want, tol)
        routes[key] = used
    for key, (b, h, s, d, dv) in FLASH_MLA.items():
        q, k, v = flash_inputs(dev, torch.bfloat16, b, h, h, s, s, d, 21,
                               layout="bshd", dv=dv)
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=True, layout="bshd"))
        if used != fk.route(torch.bfloat16, d, s, dv=dv):
            raise AssertionError(f"flash {key}: launched {used}")
        want = attention_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=True)
        errs[key], rows[key] = flash_compare(
            key, got.transpose(1, 2), want, FLASH_BF16)
        routes[key] = used
        del q, k, v, got, want
    b, hq, hkv, s, d = FLASH_INTERNLM2_PREFILL
    q, k, v = flash_inputs(dev, torch.bfloat16, b, hq, hkv, s, s, d, 24,
                           layout="bshd")
    got, used = flash_routed(fk, lambda: ops.flash_attention(
        q, k, v, causal=True, layout="bshd"))
    if used != "prefill_tc":
        raise AssertionError(f"flash prefill_internlm2: launched {used}")
    want = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)), causal=True)
    key = "prefill_internlm2_bfloat16"
    errs[key], rows[key] = flash_compare(key, got.transpose(1, 2), want,
                                         FLASH_BF16)
    routes[key] = used
    del q, k, v, got, want
    for i, (key, case) in enumerate({**FLASH_FAMILIES,
                                     **FLASH_FAMILIES_TRAIN}.items()):
        q, k, v, lens = family_flash_inputs(dev, case, 25 + i)
        causal = case[6]
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=causal, kv_len=lens, layout="bshd"))
        if used != fk.route(torch.bfloat16, case[5], case[3]):
            raise AssertionError(f"flash {key}: launched {used}")
        want = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                             causal=causal, kv_len=lens)
        errs[key], rows[key] = flash_compare(key, got.transpose(1, 2), want,
                                             FLASH_BF16)
        routes[key] = used
        del q, k, v, got, want
    for dtype, tol in ((torch.bfloat16, FLASH_BF16), (torch.float32,
                                                       FLASH_F32)):
        q, k, v, kv_len = decode_inputs(dev, dtype)
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=True, kv_len=kv_len, layout="bshd"))
        want = attention_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=True,
            kv_len=kv_len)
        key = f"decode_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "decode", got.transpose(1, 2), want, tol)
        routes[key] = used
        split = attention_split_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), kv_len, fk.DECODE_SPLIT)
        key = f"decode_vs_split_ref_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "decode vs split ref", got.transpose(1, 2), split, tol)
    for part, new in zip((errs, rows, routes), flash_int8_cases(dev)):
        part.update(new)
    emit("flash", max_abs_err=errs, row_err_over_norm=rows, routes=routes,
         tol_f32=FLASH_F32,
         tol_bf16=FLASH_BF16, prefill_shape=list(FLASH_PREFILL),
         mla_shapes={k: list(v) for k, v in FLASH_MLA.items()},
         internlm2_prefill_shape=list(FLASH_INTERNLM2_PREFILL),
         family_shapes={k: list(v[:7]) for k, v in FLASH_FAMILIES.items()},
         family_train_shapes={k: list(v[:7])
                              for k, v in FLASH_FAMILIES_TRAIN.items()},
         int8=dict(cache=FLASH_INT8_CACHE, kv_len=list(FLASH_INT8_LENS),
                   groups_head_dims=[list(c) for c in FLASH_INT8_CASES],
                   bit_for_bit_with_dequantized=True),
         decode=dict(slots=FLASH_DECODE[0], heads=FLASH_DECODE[1],
                     head_dim=FLASH_DECODE[2], cache=SERVE_CACHE,
                     kv_len=decode_inputs(dev)[3].tolist()))
    return max(errs.values())


def linrec_inputs(dev, b, h, t, d, seed, *, lo=-6.0, hi=3.0, layout="bhtd"):
    """r, k, v normal; logw = -exp(U(lo, hi)), by default the model's decay
    range up to strong decays (w = exp(logw) down to e^-20; the model's
    whole range is lo = -20, hi = 10); u normal; a nonzero state."""
    gen = torch.Generator().manual_seed(seed)
    shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
    r, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    logw = -torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen))
    u = torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    return [x.to(dev) for x in (r, k, v, logw, u, s0)]


def phase_linrec(dev):
    """The RWKV6 kernels (one call: chunk, state scan, inter) against the
    chunked plain version: ragged T, both layouts, a carried state, the
    model's whole decay range, a chunk whose decay is exactly 0, B = 2 at
    T = 2048, and the main shape; there also the states the scan leaves in
    the scratch against the chunk-parallel plain version's."""
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.linrec import ops
    from repro_torch.kernels.linrec.ref import (
        rwkv6_chunk_parallel_ref,
        rwkv6_chunked_ref,
    )
    errs = {}
    cases = {  # (b, h, t, d, layout, logw range)
        "single_chunk": (1, 2, 32, 16, "bhtd", (-6.0, 3.0)),
        "ragged_70": (2, 3, 70, 16, "bhtd", (-6.0, 3.0)),
        "t_33_d32": (2, 2, 33, 32, "bthd", (-6.0, 3.0)),
        "ragged_1000_d64": (1, 4, 1000, 64, "bthd", (-6.0, 3.0)),
        "one_step": (3, 2, 1, 64, "bhtd", (-6.0, 3.0)),
        "model_range_1000": (2, 4, 1000, 64, "bthd", (-20.0, 10.0)),
        "b2_bthd_2048": (2, 40, 2048, 64, "bthd", (-6.0, 3.0)),
        "zero_decay_chunk": (2, 3, 130, 64, "bhtd", (-20.0, 10.0)),
    }
    for i, (name, (b, h, t, d, layout, (lo, hi))) in enumerate(cases.items()):
        r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, i, lo=lo,
                                             hi=hi, layout=layout)
        if name == "zero_decay_chunk":  # exp(sum logw) of chunk 1 is 0
            logw[:, :, 32:64] = -float(np.exp(10.0))
        y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0,
                                               layout=layout)
        if layout == "bthd":
            r, k, v, logw, y = (x.transpose(1, 2) for x in (r, k, v, logw, y))
        wy, ws = rwkv6_chunked_ref(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
            raise AssertionError(f"linrec {name}: non-finite output")
        for label, a, b_ in (("y", y, wy), ("state", s, ws)):
            torch.testing.assert_close(
                a, b_, **LINREC_TOL, msg=lambda m: f"linrec {name} {label}: {m}")
        errs[name] = float(torch.maximum((y - wy).abs().max(),
                                         (s - ws).abs().max()))
    # w = 1e-6 everywhere: the decay that breaks the factored form
    r, k, v, _, u, s0 = linrec_inputs(dev, 1, 2, 64, 16, 9)
    logw = torch.full_like(r, float(np.log(1e-6)))
    y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0)
    if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
        raise AssertionError("linrec: non-finite output at w = 1e-6")
    wy, ws = rwkv6_chunked_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, wy, **LINREC_TOL)
    errs["w_1e-6"] = float((y - wy).abs().max())
    b, h, t, d = LINREC_MAIN
    r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, 10,
                                         layout="bthd")
    y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0,
                                           layout="bthd")
    bhtd = [x.transpose(1, 2) for x in (r, k, v, logw)]
    wy, ws = rwkv6_chunked_ref(*bhtd, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.transpose(1, 2), wy, **LINREC_TOL)
    torch.testing.assert_close(s, ws, **LINREC_TOL)
    errs["main"] = float(torch.maximum((y.transpose(1, 2) - wy).abs().max(),
                                       (s - ws).abs().max()))
    if not torch.isfinite(y).all():
        raise AssertionError("linrec: non-finite output at the main shape")
    # the states entering each chunk, as the scan leaves them in scratch
    _, _, entering = lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1,
                                   entering=True)
    _, _, want = rwkv6_chunk_parallel_ref(*bhtd, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(entering, want, **LINREC_TOL,
                               msg=lambda m: f"linrec entering states: {m}")
    errs["main_entering_states"] = float((entering - want).abs().max())
    emit("linrec", max_abs_err=errs, tol=LINREC_TOL,
         main_shape=list(LINREC_MAIN),
         logw_range=[-float(np.exp(3.0)), -float(np.exp(-6.0))],
         model_logw_range=[-float(np.exp(10.0)), -float(np.exp(-20.0))],
         entering_states_shape=list(entering.shape))
    return max(errs.values())


def mamba_inputs(dev, b, s, d, n, seed):
    """The scan's inputs as the Mamba layer makes them: delta =
    softplus(normal), a = -exp(uniform(-1, 2)) (decays e^-0.4 to e^-e^2 a
    unit of delta), bm, cm, x and h0 normal; float32 on ``dev``: (delta,
    x, a, bm, cm, h0)."""
    gen = torch.Generator().manual_seed(seed)
    delta = torch.nn.functional.softplus(torch.randn(b, s, d, generator=gen))
    x = torch.randn(b, s, d, generator=gen)
    a = -torch.exp(torch.rand(d, n, generator=gen) * 3.0 - 1.0)
    bm, cm = (torch.randn(b, s, n, generator=gen) for _ in range(2))
    h0 = torch.randn(b, d, n, generator=gen)
    return [t.to(dev) for t in (delta, x, a, bm, cm, h0)]


def phase_mamba(dev):
    """The Mamba scan kernels against their plain step loops on the card.
    The forward at MAMBA_CHECKS (jamba's d_inner 8192 and N 16 at S = 1,
    13, 64 and 2048, and N = 8 at a ragged B = 2 shape): y and the final
    h within MAMBA_TOL of their largest magnitude, one launch a call, a
    rerun bit for bit.  The backward at MAMBA_BWD_CHECKS from the
    forward's chunk-start states, with and without a final state's
    gradient: every gradient within MAMBA_BWD_TOL of its largest against
    mamba_scan_bwd_ref, one backward launch a call, a rerun bit for bit;
    and the trainable op under autograd (one forward and one backward
    launch, the same bits).  Returns the largest error of y and of the
    gradients."""
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bwd_ref,
        mamba_scan_ref,
    )
    cases = {}
    for i, (b, s, d, n) in enumerate(MAMBA_CHECKS):
        args = mamba_inputs(dev, b, s, d, n, 50 + i)
        before = mk.LAUNCHES
        y, h = ops.mamba_scan(*args)
        if mk.LAUNCHES != before + 1:
            raise AssertionError("mamba: the scan did not launch its kernel")
        want = mamba_scan_ref(*args)
        torch.cuda.synchronize()
        res = {}
        for label, got, ref in zip(("y", "h"), (y, h), want):
            err, big = float((got - ref).abs().max()), float(ref.abs().max())
            if not err <= MAMBA_TOL * big:
                raise AssertionError(f"mamba {(b, s, d, n)} {label}: {err} "
                                     f"> {MAMBA_TOL} x {big}")
            res[label] = dict(max_abs_err=err, largest=big)
        again = ops.mamba_scan(*args)
        if not all(torch.equal(u, w) for u, w in zip((y, h), again)):
            raise AssertionError(f"mamba {(b, s, d, n)}: a rerun differs")
        cases[f"{b}x{s}x{d}x{n}"] = res
    names = ("ddelta", "dx", "da", "dbm", "dcm", "dh0")
    bwd = {}
    for i, (b, s, d, n) in enumerate(MAMBA_BWD_CHECKS):
        args = mamba_inputs(dev, b, s, d, n, 70 + i)
        gen = torch.Generator(device=dev).manual_seed(80 + i)
        dy = torch.randn(b, s, d, generator=gen, device=dev)
        dh = torch.randn(b, d, n, generator=gen, device=dev)
        _, _, states = mk.mamba_scan_cuda(*args)
        for dh_final in (dh, None):
            before = mk.BWD_LAUNCHES
            got = mk.mamba_scan_bwd_cuda(*args[:5], dy, states, dh_final)
            if mk.BWD_LAUNCHES != before + 1:
                raise AssertionError("mamba: the backward did not launch")
            want = mamba_scan_bwd_ref(*args, dy, dh_final)
            torch.cuda.synchronize()
            res = {}
            for label, g, w in zip(names, got, want):
                err, big = float((g - w).abs().max()), float(w.abs().max())
                if not err <= MAMBA_BWD_TOL * big:
                    raise AssertionError(
                        f"mamba backward {(b, s, d, n)} {label}: {err} > "
                        f"{MAMBA_BWD_TOL} x {big}")
                res[label] = dict(max_abs_err=err, largest=big)
            again = mk.mamba_scan_bwd_cuda(*args[:5], dy, states, dh_final)
            if not all(torch.equal(u, w) for u, w in zip(got, again)):
                raise AssertionError(
                    f"mamba backward {(b, s, d, n)}: a rerun differs")
            key = f"{b}x{s}x{d}x{n}" + ("" if dh_final is not None
                                        else " no dh_final")
            bwd[key] = res
        del want
        # the trainable op: one forward and one backward launch, the same
        # bits as the direct calls
        leaves = [t.clone().requires_grad_() for t in args]
        f0, b0 = mk.LAUNCHES, mk.BWD_LAUNCHES
        y, h = ops.mamba_scan_trainable(*leaves)
        grads = torch.autograd.grad((y, h), leaves, (dy, dh))
        if (mk.LAUNCHES, mk.BWD_LAUNCHES) != (f0 + 1, b0 + 1):
            raise AssertionError("mamba: the trainable op's launches")
        direct = mk.mamba_scan_bwd_cuda(*args[:5], dy, states, dh)
        if not all(torch.equal(g, w) for g, w in zip(grads, direct)):
            raise AssertionError("mamba: the trainable op's gradients "
                                 "differ from the backward kernel's")
    emit("mamba", cases=cases, tol_of_largest=MAMBA_TOL,
         backward=bwd, backward_tol_of_largest=MAMBA_BWD_TOL,
         rerun_bit_for_bit=True, trainable_op_bit_for_bit=True)
    return (max(c["y"]["max_abs_err"] for c in cases.values()),
            max(g["max_abs_err"] for c in bwd.values() for g in c.values()))


def walk_inputs(dev, n, p, t, seed, clouds=None):
    """Revocation parameters for ``p`` pools on the synthetic fleet's
    clouds (aws, azure, gcp in turn) and the noise of ``n`` draws over
    ``t`` hours, drawn on the card from a seeded generator."""
    from repro_torch.capacity import preemption as pe
    clouds = clouds or [("aws", "azure", "gcp")[i % 3] for i in range(p)]
    params = pe.params_for_clouds(clouds, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return params, pe.draw_noise(params, t, n, gen)


def phase_walk(dev):
    """The revocation-walk kernel against its plain per-hour loop, both on
    the card: one hour; ragged hours (not a multiple of the kernel's
    unroll) over ragged lanes (not a multiple of its block); every lane
    starting available and every lane starting revoked; hazard 0 with
    recovery 1; the main shape.  States and interruptions bit for bit,
    prices within WALK_PRICE_TOL, and a rerun equal to the first run."""
    from repro_torch.capacity import preemption as pe
    cases = {  # (draws, pools, hours, start, params override)
        "one_hour": (3, 5, 1, None, None),
        "ragged": (3, 37, 1001, None, None),
        "all_available": (2, 70, 333, 1.0, None),
        "all_revoked": (2, 70, 333, 0.0, None),
        "hazard0_recovery1": (4, 33, 200, None, (0.0, 1.0)),
        "main": WALK_MAIN + (None, None),
    }
    errs = {}
    for i, (name, (n, p, t, start, rates)) in enumerate(cases.items()):
        params, (avail0, us, zs) = walk_inputs(dev, n, p, t, 30 + i)
        if start is not None:
            avail0 = torch.full_like(avail0, start)
        if rates is not None:
            params = pe.PreemptionParams(
                torch.full_like(params.hazard, rates[0]),
                torch.full_like(params.recovery, rates[1]),
                params.discount, params.price_band)
        got = pe.revocation_walk(params, avail0, us, zs)
        again = pe.revocation_walk(params, avail0, us, zs)
        want = pe.revocation_walk_loop(params, avail0, us, zs)
        torch.cuda.synchronize()
        for field in ("available", "interrupted", "price"):
            a, b = getattr(got, field), getattr(again, field)
            if not torch.equal(a, b):
                raise AssertionError(f"walk {name}: rerun differs ({field})")
        for field in ("available", "interrupted"):
            if not torch.equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(
                    f"walk {name}: {field} differs from the plain version")
        err = float((got.price - want.price).abs().max())
        if not err <= WALK_PRICE_TOL:
            raise AssertionError(f"walk {name}: price error {err}")
        if rates is not None and not bool(got.available.all()):
            raise AssertionError(f"walk {name}: revoked with hazard 0")
        errs[name] = err
        del got, again, want, avail0, us, zs
    emit("walk", max_abs_price_err=errs, price_tol=WALK_PRICE_TOL,
         states_bit_for_bit=True, rerun_bit_for_bit=True,
         main_shape_n_p_t=list(WALK_MAIN))
    return max(errs.values())


def turnover_args(base, edges):
    """The kernel wrapper's arguments for ``edges`` on base (P, T), with
    the unit table ops builds, so a timed call is the launch alone."""
    from repro_torch.capacity import generations as gn
    from repro_torch.kernels.generation_turnover import ops
    unit_rows, unit_edge = ops.units(base.shape[0], edges.src.tolist(),
                                     edges.dst.tolist(), base.device)
    return (base, unit_rows, unit_edge,
            edges.inv_gain, edges.midpoint_hours, edges.rate_per_hour,
            gn._sw_log(gn.MigrationConfig().software_efficiency_per_year))


def phase_turnover(dev, base):
    """The generation-turnover kernel against its plain version, both on
    the card: one hour; ragged hours over a turnover fleet of 14 pools; a
    fleet with no edges (pure deflation); edges at the first and last
    pool; the main shape, ``base`` (the turnover fleet before turnover),
    with its perf-adjusted volume conserved and a rerun equal to the first
    run; and the kernel against the per-hour loop on the main shape's
    first TURNOVER_LOOP_HOURS.  Bit for bit throughout.  Returns (max abs
    error, timing)."""
    from repro_torch.capacity import generations as gn
    from repro_torch.data import traces
    from repro_torch.kernels.generation_turnover import generation_turnover as gk
    from repro_torch.kernels.generation_turnover.ref import turnover_ref
    cfg = gn.MigrationConfig()
    sw_log = gn._sw_log(cfg.software_efficiency_per_year)

    def fleet_case(pools):
        edges = gn.migration_edges(pools.keys, cfg, device=dev)
        return torch.from_numpy(pools.demand).to(dev), edges

    gen = torch.Generator().manual_seed(50)
    ends = torch.rand(6, 513, generator=gen).mul(200.0).to(dev)
    first_last = (ends, gn.MigrationEdges(
        src=torch.tensor([5], device=dev), dst=torch.tensor([0], device=dev),
        uplift=torch.tensor([0.25], device=dev),
        inv_gain=1.0 / (1.0 + torch.tensor([0.25], device=dev)),
        midpoint_hours=torch.tensor([256.0], device=dev),
        rate_per_hour=torch.tensor([0.02], device=dev)))
    cases = {
        "one_hour": fleet_case(traces.synthetic_base_pool_set(
            num_pools=8, num_hours=1, seed=1)),
        "ragged": fleet_case(traces.synthetic_base_pool_set(
            num_pools=14, num_hours=1001, seed=2)),
        "no_edges": fleet_case(traces.synthetic_pool_set(
            num_pools=5, num_hours=777, seed=3)),
        "first_last": first_last,
        "main": fleet_case(base),
    }
    out = {}
    for name, (b, edges) in cases.items():
        got = gn.migrate_demand(b, edges)
        want = turnover_ref(b, edges.src, edges.dst, edges.inv_gain,
                            edges.midpoint_hours, edges.rate_per_hour,
                            sw_log)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"turnover {name}: differs from the plain version by "
                f"{float((got - want).abs().max())}")
        out[name] = dict(shape=list(b.shape), edges=edges.num_edges)
    if not torch.equal(cases["no_edges"][0] * torch.exp(
            -sw_log * torch.arange(777, dtype=torch.float32, device=dev)),
            gn.migrate_demand(*cases["no_edges"])):
        raise AssertionError("turnover without edges is not the deflation")

    b, edges = cases["main"]
    got = gn.migrate_demand(b, edges)
    again = gn.migrate_demand(b, edges)
    if not torch.equal(got, again):
        raise AssertionError("turnover main: a rerun differs")
    t = torch.arange(b.shape[1], dtype=torch.float64, device=dev)
    eff = gn.software_deflator(t.float(), cfg.software_efficiency_per_year)
    perf = torch.ones(b.shape[0], dtype=torch.float64, device=dev)
    perf[edges.dst] = 1.0 + edges.uplift.double()
    vol = float(((got.double() / eff.double()) * perf[:, None]).sum())
    vol_rel = abs(vol / float(b.double().sum()) - 1.0)
    if vol_rel > TURNOVER_VOLUME_RTOL:
        raise AssertionError(f"turnover main: volume moved by {vol_rel}")

    hb = b[:, :TURNOVER_LOOP_HOURS].contiguous()
    got = gn.migrate_demand(hb, edges)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = gn.migrate_demand_loop(hb, edges)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if not torch.equal(got, loop):
        raise AssertionError(
            "turnover: kernel differs from the per-hour loop by "
            f"{float((got - loop).abs().max())}")
    del got, again, loop, hb

    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    args = turnover_args(b, edges)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: gk.generation_turnover_cuda(*args),
        lambda: turnover_ref(b, edges.src, edges.dst, edges.inv_gain,
                             edges.midpoint_hours, edges.rate_per_hour,
                             sw_log))
    p, t, g = b.shape[0], b.shape[1], edges.num_edges
    # every row read once and written once, and the edges' five columns
    # (src, dst as int32, gain, midpoint, rate); the unit table is the
    # kernel's own layout of src and dst, not more input
    nbytes = 4 * (2 * p * t + 5 * g)
    nops = (TURNOVER_PAIR_OPS * g + (p - 2 * g) + TURNOVER_HOUR_OPS) * t
    ms_bound, by = bound(nops, nbytes, peak["fp32_flops"], peak)
    timing = dict(shape_p_t=[p, t], edges=g, ms=ms, plain_ms=plain_ms,
                  kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                  bound_ms=ms_bound, bound_by=by, bound_bytes=nbytes,
                  bound_ops=nops,
                  share_of_bound=ms_bound / ms,
                  loop_s=loop_s, loop_shape_p_t=[p, TURNOVER_LOOP_HOURS])
    emit("turnover", cases=out, bit_for_bit=True, rerun_bit_for_bit=True,
         loop_bit_for_bit=True, volume_rel=vol_rel, nvidia_smi=smi(),
         **timing)
    return 0.0, timing


def serve_prompt_lengths():
    """The serve phases' prompt lengths (numpy seed 0) and the generator
    that goes on to draw their tokens."""
    rng = np.random.default_rng(0)
    return rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SERVE_REQUESTS), rng


def serve(engine, requests):
    """Admit in arrival order while slots are free, tick, until every
    request is done; all requests arrive at t = 0.  Returns host-clock
    timings (each admission and tick ends in a device-to-host copy)."""
    pending = list(requests)
    ttft, prefill_one, prefill_s, tick_s, decoded, ticks = {}, {}, 0.0, 0.0, 0, 0
    t_start = time.perf_counter()
    while pending or engine.active_slots:
        while pending:
            t0 = time.perf_counter()
            if not engine.try_admit(pending[0]):
                break
            t1 = time.perf_counter()
            prefill_s += t1 - t0
            prefill_one[pending[0].rid] = t1 - t0
            ttft[pending.pop(0).rid] = t1 - t_start
        t0 = time.perf_counter()
        active = engine.active_slots
        engine.tick()
        tick_s += time.perf_counter() - t0
        decoded += active
        ticks += 1
    return dict(wall_s=time.perf_counter() - t_start, prefill_s=prefill_s,
                decode_s=tick_s, decode_tokens=decoded, ticks=ticks,
                ttft=ttft, prefill_one=prefill_one)


def expected_flash_mix(cfg, ticks):
    """A serve run's flash launches by kernel, from the config: every
    prompt (more than one token) prefills each attention layer once on the
    kernel the route names for the layer's head dims; a GQA model decodes
    each attention layer once a tick, on the route of one query; an MLA
    model decodes in the absorbed form, with no flash launch.  Whisper's
    attention layers are its encoder's (prefill only, over encoder_seq
    frames) and its decoder's self- and cross-attention; jamba's are the
    layers ``cfg.is_attn_layer`` names."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    dtype = getattr(torch, cfg.dtype)
    mix = dict.fromkeys(fk.SOURCES, 0)
    attn_layers = sum(map(cfg.is_attn_layer, range(cfg.num_layers)))
    if cfg.family == "audio":
        mix[fk.route(dtype, cfg.head_dim, cfg.encoder_seq)] += (
            cfg.encoder_layers * SERVE_REQUESTS)
        attn_layers = 2 * cfg.num_layers
    per_prompt = attn_layers * SERVE_REQUESTS
    if cfg.attention == "mla":
        dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
        mix[fk.route(dtype, dqk, PROMPT_MIN, dv=cfg.v_head_dim)] += per_prompt
    else:
        mix[fk.route(dtype, cfg.head_dim, PROMPT_MIN)] += per_prompt
        mix[fk.route(dtype, cfg.head_dim, 1)] += attn_layers * ticks
    return mix


def moe_tick_bytes(cfg):
    """Bytes of expert weights one decode tick's MoE layers read: at the
    tick's capacity (8 slots: the floor of 8 rows an expert) every
    expert's buffer holds rows, so the batched products read all E
    experts' w_gate, w_up and w_down in every MoE layer."""
    moe_layers = sum(map(cfg.is_moe_layer, range(cfg.num_layers)))
    elem = getattr(torch, cfg.dtype).itemsize
    return moe_layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff * elem


@dataclasses.dataclass
class InputRequest:
    """A request of the engine's shape for ApplyEngine: a vlm prompt's
    (S, d) embeddings, or a whisper prompt's tokens with the clip's
    encoder frames (encoder_seq, d) on the card."""
    rid: int
    prompt: "np.ndarray | torch.Tensor"
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    frames: "torch.Tensor | None" = None


class ApplyEngine:
    """The serving engine's steps on ``Model.apply``, for a model the
    engine refuses because it prefills on ``embeds`` (qwen2-vl) or
    ``enc_frames`` (whisper): each request prefilled alone into its slot's
    view of the pool cache (``Model.slot_view``), then one batched decode
    a tick at per-slot positions, idle slots decoding a dummy token at
    their old position.  A vlm request's prompt is its (S, d) embeddings;
    each sampled token's next input is its row of ``table``, a stand-in
    text embedding made here (the reference has none: it stubs the
    frontend).  A whisper request carries its frames; decode reads the
    cached cross k/v."""

    def __init__(self, model, *, num_slots, cache_len, table=None):
        self.model, self.num_slots = model, num_slots
        self.cache_len, self.table = cache_len, table
        self.cache = model.init_cache(num_slots, cache_len)
        self.slot_req = [None] * num_slots
        self.slot_pos = np.zeros(num_slots, np.int64)
        self.slot_limit = np.zeros(num_slots, np.int64)

    @property
    def active_slots(self):
        return sum(r is not None for r in self.slot_req)

    def prefill_inputs(self, req):
        """``Model.apply``'s inputs for ``req``'s prompt, batch 1."""
        if self.table is not None:
            return dict(embeds=req.prompt[None])
        return dict(tokens=torch.as_tensor(
            np.asarray(req.prompt, np.int64)[None], device=self.model.device),
            enc_frames=req.frames[None])

    def try_admit(self, req):
        for slot, occupant in enumerate(self.slot_req):
            if occupant is None:
                logits, _ = self.model.apply(
                    **self.prefill_inputs(req), mode="prefill",
                    cache=self.model.slot_view(self.cache, slot), pos=0)
                req.generated.append(int(logits[0, -1].argmax()))
                self.slot_req[slot] = req
                self.slot_pos[slot] = len(req.prompt)
                self.slot_limit[slot] = len(req.prompt) + req.max_new_tokens
                return True
        return False

    def tick(self):
        if self.active_slots == 0:
            return
        tokens = np.zeros((self.num_slots, 1), np.int64)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                tokens[slot, 0] = req.generated[-1]
        dev = self.model.device
        tok = torch.as_tensor(tokens, device=dev)
        inputs = (dict(embeds=self.table[tok]) if self.table is not None
                  else dict(tokens=tok))
        logits, _ = self.model.apply(
            **inputs, mode="decode", cache=self.cache,
            pos=torch.as_tensor(self.slot_pos, device=dev))
        nxt = logits[:, 0].argmax(-1).cpu().numpy()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.generated.append(int(nxt[slot]))
            self.slot_pos[slot] += 1
            if self.slot_pos[slot] >= self.slot_limit[slot]:
                req.done = True
                self.slot_req[slot] = None


def token_traffic(model, dev):
    """serve_prompt_lengths()' 16 token prompts through the port's engine:
    (prompt lengths, requests, engine)."""
    from repro_torch.serve.engine import Request, ServeEngine
    lens, rng = serve_prompt_lengths()
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = [Request(i, p, NEW_TOKENS) for i, p in enumerate(prompts)]
    return lens, reqs, ServeEngine(model, num_slots=SERVE_SLOTS,
                                   cache_len=SERVE_CACHE)


def vlm_traffic(model, dev):
    """serve_prompt_lengths()' 16 prompts as (S, d) embeddings drawn on the
    card (seed 1), and a (vocab, d) stand-in text table (the same
    generator) for the decode's inputs, driven by ApplyEngine."""
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                        device=dev).to(model.dtype)
    lens, _ = serve_prompt_lengths()
    reqs = [InputRequest(i, torch.randn(int(n), cfg.d_model, generator=gen,
                                        device=dev).to(model.dtype),
                         NEW_TOKENS) for i, n in enumerate(lens)]
    return lens, reqs, ApplyEngine(model, num_slots=SERVE_SLOTS,
                                   cache_len=SERVE_CACHE, table=table)


def audio_traffic(model, dev):
    """16 clips of encoder_seq frames (30 s each, drawn on the card, seed
    1) with decoder prompts of AUDIO_PROMPT_MIN-AUDIO_PROMPT_MAX tokens
    (numpy seed 0), driven by ApplyEngine with a cache of AUDIO_CACHE."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    lens = rng.integers(AUDIO_PROMPT_MIN, AUDIO_PROMPT_MAX + 1,
                        SERVE_REQUESTS)
    gen = torch.Generator(device=dev).manual_seed(1)
    reqs = [InputRequest(
        i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), NEW_TOKENS,
        frames=torch.randn(cfg.encoder_seq, cfg.d_model, generator=gen,
                           device=dev).to(model.dtype))
        for i, n in enumerate(lens)]
    return lens, reqs, ApplyEngine(model, num_slots=SERVE_SLOTS,
                                   cache_len=AUDIO_CACHE)


def phase_serve(name, cfg, dev, counted, extra=None, traffic=token_traffic):
    """The model of ``cfg`` at its full size served in the engine's steps:
    the main path of the kernel named ``counted``; the flash launches by
    kernel are ``expected_flash_mix``'s, exactly, with an int8 KV cache
    every decode_split launch is the int8 instance (none without), and
    the Mamba scan launches once per Mamba layer and prompt (none in a
    model without Mamba layers).  ``traffic(model, dev)`` gives the
    prompt lengths, the requests and the engine (the port's
    ``ServeEngine``, or ``ApplyEngine`` for a model it refuses).
    ``extra(model, prompts, engine)`` adds fields before the model is
    freed."""
    from repro_torch.models.model import build
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lens, reqs, engine = traffic(model, dev)
    prompts = [r.prompt for r in reqs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = serve(engine, reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and len(r.generated) == NEW_TOKENS + 1 for r in reqs):
        raise AssertionError(f"{name}: not every request got "
                             f"{NEW_TOKENS + 1} tokens")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{name}: token ids outside the vocabulary")
    if launches[counted] == 0:
        raise AssertionError(f"{name}: no {counted} launch on its main path")
    ticks = stats["ticks"]
    mix = None
    if counted == "flash_attention":
        mix = expected_flash_mix(cfg, ticks)
        want = sum(mix.values())
    else:  # prefill only: a one-token decode step needs no kernel
        want = cfg.num_layers * SERVE_REQUESTS
    if launches[counted] != want:
        raise AssertionError(
            f"{name}: {launches[counted]} {counted} launches, expected {want}")
    if mix is not None and launches["flash_by_kernel"] != mix:
        raise AssertionError(f"{name}: flash launches by kernel "
                             f"{launches['flash_by_kernel']}, expected "
                             f"{mix}")
    int8_want = (launches["flash_by_kernel"]["decode_split"]
                 if cfg.kv_cache_dtype == "int8" else 0)
    if launches["flash_int8"] != int8_want:
        raise AssertionError(f"{name}: {launches['flash_int8']} int8 decode "
                             f"launches, expected {int8_want}")
    mamba_layers = (cfg.num_layers - sum(map(cfg.is_attn_layer,
                                             range(cfg.num_layers)))
                    if cfg.family == "hybrid" else 0)
    if launches["mamba_scan"] != mamba_layers * SERVE_REQUESTS:
        raise AssertionError(f"{name}: {launches['mamba_scan']} Mamba scan "
                             f"launches, expected {mamba_layers} x "
                             f"{SERVE_REQUESTS}")
    # The engine against a direct prefill of the first request in a fresh
    # one-slot cache: finite logits and the engine's first token.
    cache = model.init_cache(1, engine.cache_len)
    direct = (engine.prefill_inputs(reqs[0])
              if isinstance(engine, ApplyEngine) else dict(
                  tokens=torch.as_tensor(prompts[0][None], device=dev)))
    logits, _ = model.apply(**direct, mode="prefill", cache=cache, pos=0)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite prefill logits")
    if int(logits[0, -1].argmax()) != reqs[0].generated[0]:
        raise AssertionError(f"{name}: engine's first token != direct "
                             "prefill's")
    names = (RWKV6_PROFILE_NAMES if mix is None else tuple(
        n for kern, count in mix.items() if count
        for n in FLASH_PROFILE_NAMES[kern]))
    scan_names = ("scan_chunks", "scan_combine")  # the forward's kernels
    if mamba_layers:
        names += scan_names
    prof = profile_serving(name, engine, reqs, stats, counted, names)
    if mamba_layers:  # the scan's device ms in the longest prompt's prefill
        by_name = prof["prefill_longest"]["kernel_device_s_by_name"]
        prof["prefill_longest"]["mamba_scan_ms"] = 1e3 * sum(
            by_name[n] for n in scan_names)
    ttft = sorted(stats["ttft"].values())
    out = dict(
        arch=cfg.name, params=model.num_params(), dtype=cfg.dtype,
        layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        engine=type(engine).__name__, slots=SERVE_SLOTS,
        cache_len=engine.cache_len, requests=SERVE_REQUESTS,
        prompt_tokens=int(lens.sum()), prompt_len_min_max=[int(lens.min()),
                                                           int(lens.max())],
        new_tokens=NEW_TOKENS, init_s=init_s, wall_s=stats["wall_s"],
        prefill_s=stats["prefill_s"],
        prefill_tokens_per_s=float(lens.sum()) / stats["prefill_s"],
        decode_s=stats["decode_s"], decode_ticks=ticks,
        decode_tokens=stats["decode_tokens"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"],
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        ttft_first_s=ttft[0], launches=launches, expected_flash_mix=mix,
        kv_cache_dtype=cfg.kv_cache_dtype, max_memory_allocated=peak,
        profile=prof, **(extra(model, prompts, engine) if extra else {}))
    if cfg.num_experts:
        # the decode tick's expert products against the bytes they must
        # read: every expert's weights (moe_tick_bytes)
        peak_rates = PEAKS["pcie" if "PCIe" in torch.cuda.get_device_name(0)
                           else "sxm"]
        nbytes = moe_tick_bytes(cfg)
        bound_s = nbytes / peak_rates["bytes"]
        experts_s = prof["decode_tick"]["ranges_device_s"]["moe_experts"]
        out["moe_decode_tick"] = dict(
            expert_bytes=nbytes, bytes_bound_s=bound_s,
            experts_device_s=experts_s,
            bound_share=bound_s / experts_s if experts_s else None,
            experts_share_of_tick=experts_s
            / prof["decode_tick"]["unprofiled_s"])
    emit(name, **out)
    del engine, model, cache
    torch.cuda.empty_cache()
    return launches[counted], out


def profile_serving(name, engine, reqs, stats, counted, names):
    """Where serving time goes, under torch.profiler on the drained engine:
    the longest request's prefill again, then PROFILE_TICKS ticks with
    every slot busy.  Device busy time is set against the same work's
    unprofiled host-clock time from the timed run (the profiler slows the
    host), so ``device_busy_share`` is the device's share of real time.
    ``names`` are the path's kernels, each given its device time per step;
    the port's ranges (SERVE_RANGES: the MoE's expert products, MLA's
    absorbed decode) their device time per step and share of real time.
    Full tables in build/chip_smoke/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    # every kernel of the path: flash's four, RWKV6's three
    kernel = {"flash_attention": "flash_", "rwkv6": "rwkv6_"}[counted]
    longest = max(reqs, key=lambda r: len(r.prompt))

    def again(req, rid, prompt):  # the same request (its frames too) anew
        return dataclasses.replace(req, rid=rid, prompt=prompt,
                                   max_new_tokens=PROFILE_TICKS + 1,
                                   generated=[], done=False)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_pre:
        engine.try_admit(again(longest, 1000, longest.prompt))
        torch.cuda.synchronize()
    for i in range(1, SERVE_SLOTS):
        req = reqs[i % len(reqs)]
        engine.try_admit(again(req, 1000 + i, req.prompt[:PROMPT_MIN]))
    with profile(activities=acts) as prof_dec:
        for _ in range(PROFILE_TICKS):
            engine.tick()
        torch.cuda.synchronize()
    while engine.active_slots:
        engine.tick()
    out, text = {}, [smi()]
    for label, prof, real_s in (
            ("prefill_longest", prof_pre, stats["prefill_one"][longest.rid]),
            ("decode_tick", prof_dec, stats["decode_s"] * PROFILE_TICKS
             / stats["ticks"])):
        kernels = device_kernels(prof)
        busy = sum(k[0] for k in kernels) / 1e6
        own = sum(k[0] for k in kernels if kernel in k[2]) / 1e6
        launches = sum(k[1] for k in kernels)
        n = 1 if label == "prefill_longest" else PROFILE_TICKS
        by_name = {  # device seconds per step of each of the port's kernels
            part: sum(k[0] for k in kernels if part in k[2]) / 1e6 / n
            for part in names}
        ranges = {  # device seconds per step of the kernels in each range
            label: sum(ev.device_time_total for ev in prof.events()
                       if ev.name == label
                       and str(ev.device_type).endswith("CPU")) / 1e6 / n
            for label in SERVE_RANGES}
        out[label] = dict(
            unprofiled_s=real_s / n, device_busy_s=busy / n,
            device_busy_share=busy / real_s, kernel_device_s=own / n,
            kernel_device_s_by_name=by_name,
            kernel_share_of_busy=own / busy if busy else None,
            ranges_device_s=ranges,
            ranges_share_of_real={k: v * n / real_s
                                  for k, v in ranges.items()},
            device_events=launches / n,
            prompt_tokens=len(longest.prompt) if n == 1 else None,
            top=[[round(us / 1e3 / n, 4), c // n, key[:60]]
                 for us, c, key in kernels[:5]])
        text.append(f"{label}: unprofiled {real_s / n:.6f} s, device busy "
                    f"{busy / n:.6f} s per {'prefill' if n == 1 else 'tick'}")
        text += [f"{us / 1e3 / n:12.4f} ms {c / n:8.1f}x  {key}"
                 for us, c, key in kernels]
    path = ROOT / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    (path / f"profile_{name}.txt").write_text("\n".join(text) + "\n")
    return out


# the reference's bound on an int8 cache's logits against a bf16 cache's
# (tests/test_perf_knobs.py::TestInt8KVCache): err < a max|logits| + b
INT8_LOGIT_BOUND = (0.05, 0.1)
INT8_CACHE_RATIO = 0.6      # test_cache_bytes_halved: int8 bytes < 0.6 bf16
INT8_CHECKED_REQUESTS = 2


def with_cfg(model, cfg):
    """Point the model and every layer at ``cfg`` (the same weights; here
    another kv_cache_dtype)."""
    for m in model.modules():
        if getattr(m, "cfg", None) is not None:
            m.cfg = cfg


def int8_serve_checks(model, prompts, engine):
    """The int8 cache's bytes against the bf16 cache's (same slots and
    length, counted from the specs), then, on the first
    INT8_CHECKED_REQUESTS prompts, the first decode tick's logits with the
    int8 cache against the same weights with a bf16 cache, within the
    reference's bound."""
    cfg = model.cfg
    cfg_b = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    int8_bytes = sum(t.numel() * t.element_size()
                     for t in engine.cache.values())
    bf16_bytes = cfg.num_layers * sum(
        math.prod(sp.shape) * (sp.dtype or model.dtype).itemsize
        for sp in model.cache_specs(cfg_b, SERVE_SLOTS, SERVE_CACHE).values())
    if not int8_bytes < INT8_CACHE_RATIO * bf16_bytes:
        raise AssertionError(f"serve_int8: cache {int8_bytes} bytes against "
                             f"the bf16 cache's {bf16_bytes}")
    a, b = INT8_LOGIT_BOUND
    checks = []
    for prompt in prompts[:INT8_CHECKED_REQUESTS]:
        tok = torch.as_tensor(prompt[None], device=model.device)
        ticks = []
        for c in (cfg, cfg_b):
            with_cfg(model, c)
            cache = model.init_cache(1, SERVE_CACHE)
            pre, cache = model.apply(tok, mode="prefill", cache=cache, pos=0)
            nxt = pre[:, -1:].argmax(-1)
            ticks.append(model.apply(nxt, mode="decode", cache=cache,
                                     pos=len(prompt))[0])
            del cache
        with_cfg(model, cfg)
        err = float((ticks[0] - ticks[1]).abs().max())
        scale = float(ticks[1].abs().max())
        if not (torch.isfinite(ticks[0]).all() and err < a * scale + b):
            raise AssertionError(f"serve_int8: first decode tick's logits "
                                 f"{err} from the bf16 cache's (largest "
                                 f"{scale})")
        checks.append(dict(prompt_tokens=len(prompt), max_abs_err=err,
                           largest=scale, bound=a * scale + b))
    return dict(int8_cache_bytes=int8_bytes, bf16_cache_bytes=bf16_bytes,
                cache_ratio=int8_bytes / bf16_bytes,
                first_tick_vs_bf16_cache=checks)


def hybrid_cut(model, prompts, engine):
    """serve_hybrid's depth cut and what its layers hold."""
    from repro_torch import configs
    from repro_torch.models.model import num_params
    cfg = model.cfg
    full = configs.get(cfg.name)
    kinds = [(cfg.is_attn_layer(i), cfg.is_moe_layer(i))
             for i in range(cfg.num_layers)]
    return dict(
        reduced=dict(num_layers=[full.num_layers, cfg.num_layers],
                     why="the 32 layers' bf16 weights (2 x num_params "
                         "bytes) exceed one 80 GB card"),
        published_params=num_params(full),
        attention_layers=sum(a for a, _ in kinds),
        mamba_layers=sum(not a for a, _ in kinds),
        moe_layers=sum(m for _, m in kinds))


def phase_serve_families(dev):
    """serve_vlm, serve_audio, serve_hybrid (module docstring): qwen2-vl-7b
    and whisper-small through ApplyEngine (the engine refuses them), jamba
    at full width and HYBRID_LAYERS layers through the engine.  Returns
    each phase's launches by kernel."""
    from repro_torch import configs
    out = {}
    for name, cfg, traffic, extra in (
            ("serve_vlm", configs.get("qwen2-vl-7b"), vlm_traffic, None),
            ("serve_audio", configs.get("whisper-small"), audio_traffic,
             None),
            ("serve_hybrid", dataclasses.replace(
                configs.get("jamba-v0.1-52b"), num_layers=HYBRID_LAYERS),
             token_traffic, hybrid_cut)):
        _, res = phase_serve(name, cfg, dev, "flash_attention", extra=extra,
                             traffic=traffic)
        out[name] = dict(res["launches"]["flash_by_kernel"],
                         mamba_scan=res["launches"]["mamba_scan"],
                         ticks=res["decode_ticks"])
    return out


def phase_serve_int8(dev):
    """internlm2-20b at full size with kv_cache_dtype="int8" (module
    docstring, phase ``serve_int8``)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("internlm2-20b"),
                              kv_cache_dtype="int8")
    return phase_serve("serve_int8", cfg, dev, "flash_attention",
                       extra=int8_serve_checks)


def moe_drops_card_vs_cpu(dev):
    """The MoE layer alone, card against CPU in float32: the reduced
    deepseek-v2-lite at capacity factor 1.0 over MOE_DROP_TOKENS tokens,
    so that assignments drop.  The dropped counts must be equal (and not
    0), the outputs within MOE_TOL of the largest."""
    from repro_torch import configs
    from repro_torch.models.ffn import MoE
    from repro_torch.models.params import init_module
    cfg = dataclasses.replace(configs.reduced("deepseek-v2-lite-16b"),
                              dtype="float32", moe_capacity_factor=1.0)
    cpu = MoE(cfg, dtype=torch.float32, device="cpu")
    init_module(cpu, torch.Generator().manual_seed(3))
    card = MoE(cfg, dtype=torch.float32, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(1, MOE_DROP_TOKENS, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    outs, dropped = [], []
    with torch.no_grad():
        for layer, xx in ((cpu, x), (card, x.to(dev))):
            outs.append(layer(xx).cpu())
            valid = layer.dispatch(xx.view(-1, cfg.d_model))[3]
            dropped.append(int((~valid).sum()))
    if dropped[0] != dropped[1] or dropped[0] == 0:
        raise AssertionError(f"model_cpu moe: dropped {dropped} (CPU, card)")
    err = float((outs[0] - outs[1]).abs().max())
    largest = float(outs[0].abs().max())
    if err > MOE_TOL * largest:
        raise AssertionError(f"model_cpu moe: card vs CPU {err} > "
                             f"{MOE_TOL} x {largest}")
    return dict(tokens=MOE_DROP_TOKENS, assignments=MOE_DROP_TOKENS
                * cfg.top_k, dropped=dropped[0], max_abs_err=err,
                largest=largest, tol_of_largest=MOE_TOL)


def model_cpu_families(dev):
    """The reduced float32 qwen2-vl, whisper and jamba on the CPU (plain
    versions) and the card (kernels): five requests through three slots
    (ApplyEngine for the first two, whose vlm prompts are rows of a seeded
    stand-in table and whose audio clips are seeded frames; the engine for
    jamba), tokens equal; then prefill 36 + decode 1 and the train-mode
    forward on two rows, logits within MODEL_TOL.  Jamba's Mamba layers
    launch the scan kernel (its state size 8) on the card."""
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.models.model import build
    from repro_torch.serve.engine import Request, ServeEngine
    out = {}
    for arch in ("qwen2-vl-7b", "whisper-small", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        scans = mk.LAUNCHES
        cpu = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card = build(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        gen = torch.Generator().manual_seed(2)
        table = (torch.randn(cfg.vocab_size, cfg.d_model, generator=gen)
                 if cfg.embeds_input else None)
        frames = (torch.randn(5, cfg.encoder_seq, cfg.d_model, generator=gen)
                  if cfg.family == "audio" else None)
        rng = np.random.default_rng(1)
        specs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
                 for n, m in ((5, 6), (40, 4), (77, 8), (12, 5), (100, 3))]
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
        gens, results = [], []
        for model in (cpu, card):
            d = model.device
            if cfg.family == "hybrid":
                engine = ServeEngine(model, num_slots=3, cache_len=128)
                reqs = [Request(i, p, m) for i, (p, m) in enumerate(specs)]
            else:
                tab = None if table is None else table.to(d)
                engine = ApplyEngine(model, num_slots=3, cache_len=128,
                                     table=tab)
                reqs = [InputRequest(
                    i, p if tab is None else tab[torch.as_tensor(p).to(d)],
                    m, frames=None if frames is None else frames[i].to(d))
                    for i, (p, m) in enumerate(specs)]
            serve(engine, reqs)
            gens.append([r.generated for r in reqs])
            if table is not None:
                pre_in = dict(embeds=table.to(d)[tok[:, :36].to(d)])
                dec_in = dict(embeds=table.to(d)[tok[:, 36:].to(d)])
                train_in = dict(embeds=table.to(d)[tok.to(d)])
            else:
                enc = ({} if frames is None
                       else dict(enc_frames=frames[:2].to(d)))
                pre_in = dict(tokens=tok[:, :36], **enc)
                dec_in = dict(tokens=tok[:, 36:])
                train_in = dict(tokens=tok, **enc)
            cache = model.init_cache(2, 64)
            pre, cache = model.apply(**pre_in, mode="prefill", cache=cache,
                                     pos=0)
            dec, _ = model.apply(**dec_in, mode="decode", cache=cache,
                                 pos=torch.tensor([36, 36]))
            train, _ = model.apply(**train_in, mode="train")
            results.append((pre.cpu(), dec.cpu(), train.cpu()))
        if gens[0] != gens[1]:
            raise AssertionError(f"model_cpu {arch}: card tokens != CPU")
        tol, errs = MODEL_TOL[arch], {}
        for label, a, b in zip(("prefill", "decode", "train"), *results):
            torch.testing.assert_close(
                b, a, atol=tol, rtol=tol,
                msg=lambda m: f"model_cpu {arch} {label}: {m}")
            errs[label] = float((a - b).abs().max())
        scans = mk.LAUNCHES - scans
        if (scans > 0) != (cfg.family == "hybrid"):
            raise AssertionError(f"model_cpu {arch}: {scans} scan launches")
        out[arch] = dict(tokens_equal=True, max_abs_err=errs, tol=tol,
                         requests=len(specs), mamba_scan_launches=scans)
    return out


def phase_model_cpu(dev):
    """The reduced float32 configs of every served family (dense GQA,
    RWKV, MoE GQA, MoE MLA, dense MLA), one set of weights each, served on
    the CPU (plain versions) and on the card (kernels); the MLA configs at
    minicpm3's head dims (MLA_CARD_DIMS), so that their prefill runs simt
    at (Dqk, Dv) = (96, 64) and their decode no flash kernel.  Then the
    MoE layer alone, with drops (moe_drops_card_vs_cpu)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models.model import build
    from repro_torch.serve.engine import Request, ServeEngine
    out = {}
    reset_launches()
    for arch in ("stablelm-1.6b", "rwkv6-3b", "granite-moe-1b-a400m",
                 "deepseek-v2-lite-16b", "minicpm3-4b"):
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        if cfg.attention == "mla":
            cfg = dataclasses.replace(cfg, **MLA_CARD_DIMS)
        before = dict(fk.LAUNCHES_BY_KERNEL)
        cpu = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card = build(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(1)
        specs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
                 for n, m in ((5, 6), (40, 4), (77, 8), (12, 5), (100, 3))]
        gens = []
        for model in (cpu, card):
            reqs = [Request(i, p, m) for i, (p, m) in enumerate(specs)]
            serve(ServeEngine(model, num_slots=3, cache_len=128), reqs)
            gens.append([r.generated for r in reqs])
        if gens[0] != gens[1]:
            raise AssertionError(f"model_cpu {arch}: card tokens != CPU")
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
        errs = {}
        results = []
        for model in (cpu, card):
            cache = model.init_cache(2, 64)
            pre, cache = model.apply(tok[:, :36], mode="prefill",
                                     cache=cache, pos=0)
            dec, _ = model.apply(tok[:, 36:], mode="decode", cache=cache,
                                 pos=torch.tensor([36, 36]))
            train, _ = model.apply(tok, mode="train")
            results.append((pre.cpu(), dec.cpu(), train.cpu()))
        tol = MODEL_TOL[arch]
        for label, a, b in zip(("prefill", "decode", "train"), *results):
            torch.testing.assert_close(
                b, a, atol=tol, rtol=tol,
                msg=lambda m: f"model_cpu {arch} {label}: {m}")
            errs[label] = float((a - b).abs().max())
        used = {k: n - before[k] for k, n in fk.LAUNCHES_BY_KERNEL.items()}
        if cfg.attention == "mla" and (used["decode_split"] or not used[
                "simt"]):  # the absorbed decode launches no flash kernel
            raise AssertionError(f"model_cpu {arch}: flash launches {used}")
        out[arch] = dict(tokens_equal=True, max_abs_err=errs, tol=tol,
                         requests=len(specs), flash_launches_by_kernel=used,
                         head_dims_qk_v=(
                             [cfg.qk_nope_dim + cfg.qk_rope_dim,
                              cfg.v_head_dim] if cfg.attention == "mla"
                             else [cfg.head_dim] * 2 if cfg.family != "ssm"
                             else None))
    out.update(model_cpu_families(dev))
    # float32: the decode on decode_split, the prefill (and train) on simt
    flash = read_launches()["flash_by_kernel"]
    if not (flash["decode_split"] > 0 and flash["simt"] > 0
            and flash["prefill_tc"] == 0):
        raise AssertionError(f"model_cpu: flash launches by kernel {flash}")
    out["moe_drops"] = moe_drops_card_vs_cpu(dev)
    emit("model_cpu", flash_launches_by_kernel=flash, **out)


# --------------------------------------------------------------- training
# The train phase's settings: the main path (the full published config),
# the restart at full width with 2 layers, RWKV at full width with 2
# layers, the card-vs-CPU steps on the reduced float32 configs.
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 12
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5)
TRAIN_TIMED = slice(2, TRAIN_STEPS)          # steps 3-12 (1-based)
TRAIN_NO_CKPT = 10**9                        # ckpt_every: never
RESTART_LAYERS, RESTART_EVERY, RESTART_FAIL, RESTART_STEPS = 2, 4, 6, 8
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 2, 3
TRAIN_CPU_STEPS, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH = 3, 64, 2
# float32 card vs CPU from the same weights and batches:
# - step 1's gradients, each leaf within `grad` of its largest: the same
#   float32 algebra in another order; for RWKV the kernel's forward (held
#   to the chunked plain version at 2e-3, phase linrec) moves them by up
#   to 7e-5 of their largest (measured on an H100 80GB HBM3);
# - the losses of every step within rel `loss_rtol`;
# - after the last step, each leaf's update (parameters minus the
#   initial ones) within `update_rel` of its norm (the largest over the
#   leaves), and every element within twice the learning rates summed
#   (the steps' own bound): AdamW's direction m_hat / (sqrt(v_hat) + eps)
#   turns a gradient's last bits into a full-size difference where
#   sqrt(v_hat) is small, and three steps compound it (measured on an H100
#   80GB HBM3: 1.6e-4 for stablelm, 6.3e-3 for rwkv6, 6.0e-5 / 4.4e-5 /
#   5.2e-5 for granite-moe / deepseek / minicpm3, whose gradients read
#   7.1e-7 / 9.5e-7 / 1.4e-6 of their largest; 3.9e-5 / 5.1e-5 / 6.9e-4
#   for qwen2-vl / whisper / jamba, gradients 9.9e-7 / 9.9e-7 / 8.0e-6:
#   jamba's scan kernels sum in chunks of 64 steps, the plain loop step by
#   step, so its gradients are held to 2e-5).  The control, a CPU run
#   whose learning rate is 1% higher (`TRAIN_CPU_CONTROL_LR`), must read
#   above `update_rel` (on the CPU: 2.3e-2 for stablelm, 0.20 for rwkv6,
#   1.7e-2 / 2.0e-2 / 1.4e-2 for the MoE and MLA three), so the gate
#   catches a 1% error in the step's size
TRAIN_CPU_ARCHS = ("stablelm-1.6b", "rwkv6-3b", "granite-moe-1b-a400m",
                   "deepseek-v2-lite-16b", "minicpm3-4b")
TRAIN_CPU_TOL = dict(grad={"stablelm-1.6b": 1e-5, "rwkv6-3b": 2e-4,
                           "granite-moe-1b-a400m": 1e-5,
                           "deepseek-v2-lite-16b": 1e-5,
                           "minicpm3-4b": 1e-5, "qwen2-vl-7b": 1e-5,
                           "whisper-small": 1e-5, "jamba-v0.1-52b": 2e-5},
                     loss_rtol=1e-5,
                     update_rel={"stablelm-1.6b": 2e-3, "rwkv6-3b": 2e-2,
                                 "granite-moe-1b-a400m": 2e-3,
                                 "deepseek-v2-lite-16b": 2e-3,
                                 "minicpm3-4b": 2e-3, "qwen2-vl-7b": 2e-3,
                                 "whisper-small": 2e-3,
                                 "jamba-v0.1-52b": 2e-3})
# phase train_families' card-vs-CPU configs (reduced, float32; jamba's
# Mamba layers on the scan kernels' N = 8 instance)
TRAIN_CPU_FAMILY_ARCHS = ("qwen2-vl-7b", "whisper-small", "jamba-v0.1-52b")
TRAIN_CPU_CONTROL_LR = 1.01
# the trainable ops' gradients against autograd through the plain version
# on the card: both compute them in float32 from the same inputs, so only
# summation order differs; bf16 gradients are rounded once at the end
TRAIN_GRAD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                  torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the trainable RWKV6 op's gradients: the recurrence's own 2e-3, of each
# gradient's largest element
RWKV_GRAD_TOL = 2e-3


# each train_fit run's median step seconds, by label (phase cells reads
# them beside the model FLOPs)
TRAIN_STEP_S: dict[str, dict] = {}


def expect_launches(label, got, want):
    if got != want:
        raise AssertionError(f"train {label}: launches {got}, expected {want}")


def train_flash_checks(dev):
    """flash_attention_trainable on the card: its output against the plain
    version (phase flash's tolerances) and its dq, dk, dv against autograd
    through the plain version, ragged, GQA groups 1 and 4, f32 and bf16,
    at the square head dims and MLA's (Dqk, Dv) = (192, 128) and (96, 64)
    (f32 on simt, bf16 on prefill_tc), and the main paths' (4, 2048, 32,
    64) and deepseek's (4, 2048, 16, 192/128) bf16 in the model's
    layout."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = {  # (b, hq, hkv, s, dqk, dv, layout)
        "g1_s65": (1, 4, 4, 65, 64, 64, "bhsd"),
        "g4_s200": (2, 8, 2, 200, 64, 64, "bshd"),
        "g4_s65_d128": (1, 8, 2, 65, 128, 128, "bhsd"),
        "g1_s200_d32": (2, 4, 4, 200, 32, 32, "bshd"),
        "mla192_g1_s65": (1, 4, 4, 65, 192, 128, "bshd"),
        "mla192_g4_s200": (2, 8, 2, 200, 192, 128, "bhsd"),
        "mla96_g1_s200": (2, 4, 4, 200, 96, 64, "bshd"),
        "mla96_g4_s65": (1, 8, 2, 65, 96, 64, "bhsd"),
    }
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 32, 64
    errs, routes = {}, {}
    runs = [(name, c, dtype) for name, c in cases.items()
            for dtype in (torch.float32, torch.bfloat16)]
    runs.append(("main", (b, h, h, s, d, d, "bshd"), torch.bfloat16))
    runs.append(("main_mla192", (b, 16, 16, s, 192, 128, "bshd"),
                 torch.bfloat16))
    for i, (name, (b, hq, hkv, s, d, dv, layout), dtype) in enumerate(runs):
        q, k, v = (x.requires_grad_() for x in flash_inputs(
            dev, dtype, b, hq, hkv, s, s, d, 40 + i, layout, dv))
        g = flash_inputs(dev, dtype, b, hq, hq, s, s, dv, 60 + i, layout)[0]
        out, used = flash_routed(fk, lambda: ops.flash_attention_trainable(
            q, k, v, layout=layout))
        grads = torch.autograd.grad(out, (q, k, v), g)
        if used != fk.route(dtype, d, s, dv=dv):
            raise AssertionError(f"train flash {name}: launched {used}")
        bhsd = [x.transpose(1, 2) if layout == "bshd" else x
                for x in (q, k, v, g, out, *grads)]
        want = attention_ref(*bhsd[:3], causal=True)
        want_grads = torch.autograd.grad(want, bhsd[:3], bhsd[3])
        key = f"{name}_{str(dtype)[6:]}"
        tol = FLASH_F32 if dtype == torch.float32 else FLASH_BF16
        errs[key] = {"out": flash_compare(f"train {key}", bhsd[4].detach(),
                                          want.detach(), tol)[0]}
        for label, a, w, x in zip(("dq", "dk", "dv"), bhsd[5:], want_grads,
                                  bhsd[:3]):
            if a.shape != x.shape:
                raise AssertionError(f"train flash {key} {label}: shape "
                                     f"{tuple(a.shape)}")
            torch.testing.assert_close(
                a.float(), w.float(), **TRAIN_GRAD_TOL[dtype],
                msg=lambda m: f"train flash {key} {label}: {m}")
            errs[key][label] = float((a.float() - w.float()).abs().max())
        routes[key] = used
        del q, k, v, g, out, grads, bhsd, want, want_grads
    return dict(max_abs_err=errs, routes=routes, tol_grad_f32=TRAIN_GRAD_TOL[
        torch.float32], tol_grad_bf16=TRAIN_GRAD_TOL[torch.bfloat16])


def train_rwkv6_checks(dev):
    """rwkv6_trainable on the card: y and the final state against the
    chunked plain version, and the gradients of r, k, v, logw, u and the
    state against autograd through two algebras the op's backward (the
    chunked form at the kernel's chunk of 32) does not run: the step loop
    and the chunked form at chunks of 16.  Ragged T, a carried state,
    (1, 40, 2048, 64), and the train path's (4, 40, 2048, 64), all in the
    model's layout but the first."""
    from repro_torch.kernels.linrec import ops
    from repro_torch.kernels.linrec.ref import rwkv6_chunked_ref, rwkv6_ref
    cases = {  # (b, h, t, d, layout)
        "ragged_45": (2, 3, 45, 16, "bhtd"),
        "ragged_70_d64": (1, 4, 70, 64, "bthd"),
        "main": (*LINREC_MAIN, "bthd"),
        "train": (TRAIN_BATCH, *LINREC_MAIN[1:], "bthd"),
    }
    plains = {
        "step": lambda r, k, v, lw, u, s0: rwkv6_ref(r, k, v, lw.exp(), u,
                                                     s0),
        "chunked16": lambda *a: rwkv6_chunked_ref(*a, chunk=16),
    }
    errs = {}
    for i, (name, (b, h, t, d, layout)) in enumerate(cases.items()):
        ins = [x.requires_grad_() for x in linrec_inputs(
            dev, b, h, t, d, 70 + i, lo=-3.0, hi=1.0, layout=layout)]
        gen = torch.Generator().manual_seed(80 + i)
        gy = torch.randn(ins[2].shape, generator=gen).to(dev)
        gs = torch.randn(ins[5].shape, generator=gen).to(dev)
        before = kernel_modules()["rwkv6"].LAUNCHES
        y, s = ops.rwkv6_trainable(*ins, layout=layout)
        expect_launches(f"rwkv6 {name}",
                        kernel_modules()["rwkv6"].LAUNCHES - before, 1)
        grads = torch.autograd.grad((y, s), ins, (gy, gs))
        bhtd = [x.transpose(1, 2) if layout == "bthd" else x
                for x in (*ins[:4], y, gy)]
        with torch.no_grad():
            wy, ws = rwkv6_chunked_ref(*bhtd[:4], *ins[4:])
        torch.testing.assert_close(bhtd[4], wy, **LINREC_TOL)
        torch.testing.assert_close(s, ws, **LINREC_TOL)
        errs[name] = dict(y=float((bhtd[4].detach() - wy).abs().max()),
                          state=float((s.detach() - ws).abs().max()))
        del wy, ws
        for plain_name, plain in plains.items():
            wy, ws = plain(*bhtd[:4], *ins[4:])
            # both in the inputs' layout: the transposes are in the graph
            want = torch.autograd.grad((wy, ws), ins, (bhtd[5], gs))
            del wy, ws
            for label, a, w in zip(("r", "k", "v", "logw", "u", "state"),
                                   grads, want):
                scale = float(w.abs().max())
                torch.testing.assert_close(
                    a, w, rtol=RWKV_GRAD_TOL, atol=RWKV_GRAD_TOL * scale,
                    msg=lambda m: f"train rwkv6 {name} d{label} vs "
                                  f"{plain_name}: {m}")
                errs[name][f"d{label}_vs_{plain_name}"] = float(
                    (a - w).abs().max() / max(scale, 1e-30))
            del want
        del ins, y, s, grads, bhtd
        torch.cuda.empty_cache()
    return dict(max_rel_err=errs, tol_grad=RWKV_GRAD_TOL,
                shapes={n: list(c[:4]) for n, c in cases.items()})


def train_card_vs_cpu(dev, archs=TRAIN_CPU_ARCHS):
    """The reduced float32 ``archs`` (MLA at MLA_CARD_DIMS, as phase
    model_cpu runs them) on the card (kernels) and on the CPU (plain
    versions) from the same weights and batches (with the family's inputs,
    family_inputs_np): step 1's gradients, then TRAIN_CPU_STEPS train
    steps (TRAIN_CPU_TOL), beside a CPU control run at
    TRAIN_CPU_CONTROL_LR times the learning rate that the update gate must
    reject."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import (
        AdamWConfig,
        _schedule,
        init_opt_state,
    )
    from repro_torch.train.step import (
        build_loss_fn,
        build_train_step,
        init_train_state,
    )
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    control = dataclasses.replace(opt, lr=opt.lr * TRAIN_CPU_CONTROL_LR)
    bound = 2 * sum(_schedule(opt, s) for s in range(TRAIN_CPU_STEPS))

    def updates_rel(params, want):
        """The largest over the leaves of |update - wanted update| over
        |wanted update|, and the largest element of the difference."""
        rel, worst = 0.0, 0.0
        for name, p in params.items():
            diff = p.detach().cpu() - start[name] - want[name]
            rel = max(rel, float(
                diff.norm() / want[name].norm().clamp_min(1e-30)))
            worst = max(worst, float(diff.abs().max()))
        return rel, worst

    out = {}
    for arch in archs:
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        if cfg.attention == "mla":
            cfg = dataclasses.replace(cfg, **MLA_CARD_DIMS)
        models = [build(cfg, device="cpu"), build(cfg, device=dev),
                  build(cfg, device="cpu")]
        states = [init_train_state(models[0],
                                   torch.Generator().manual_seed(0))]
        for m in models[1:]:
            m.load_state_dict(models[0].state_dict())
            params = dict(m.named_parameters())
            states.append((params, init_opt_state(params)))
        start = {n: p.detach().clone() for n, p in states[0][0].items()}
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_CPU_SEQ,
                                        global_batch=TRAIN_CPU_BATCH))
        batches = [family_inputs_np(cfg, pipe.next_batch(), i)
                   for i in range(TRAIN_CPU_STEPS)]
        grads = []
        for model in models[:2]:
            loss = build_loss_fn(model)(batches[0])
            grads.append([g.cpu() for g in torch.autograd.grad(
                loss, list(model.parameters()))])
        grad_rel = max(float((b - a).abs().max() / a.abs().max())
                       for a, b in zip(*grads) if a.abs().max() > 0)
        if grad_rel > TRAIN_CPU_TOL["grad"][arch]:
            raise AssertionError(f"train card vs CPU {arch}: gradients "
                                 f"{grad_rel} of their largest apart")
        steps = [build_train_step(m, o)
                 for m, o in zip(models, (opt, opt, control))]
        losses = [[], [], []]
        for batch in batches:
            for j in range(3):
                loss, params, state = steps[j](*states[j], batch)
                states[j] = (params, state)
                losses[j].append(float(loss))
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(*losses[:2]))
        want = {n: p.detach() - start[n] for n, p in states[0][0].items()}
        update_rel, worst = updates_rel(states[1][0], want)
        control_rel, _ = updates_rel(states[2][0], want)
        tol = TRAIN_CPU_TOL["update_rel"][arch]
        if control_rel <= tol:
            raise AssertionError(
                f"train card vs CPU {arch}: the control at "
                f"{TRAIN_CPU_CONTROL_LR}x the learning rate reads "
                f"{control_rel}, within the gate {tol}")
        if (loss_rel > TRAIN_CPU_TOL["loss_rtol"] or update_rel > tol
                or worst > bound):
            raise AssertionError(
                f"train card vs CPU {arch}: losses {losses[1]} vs "
                f"{losses[0]}, updates {update_rel} of their norm apart, "
                f"{worst} at most (bound {bound})")
        out[arch] = dict(losses_card=losses[1], losses_cpu=losses[0],
                         loss_rel=loss_rel, grad_rel_to_max=grad_rel,
                         update_rel_to_norm=update_rel,
                         control_update_rel_to_norm=control_rel,
                         param_max_abs=worst, param_bound=bound,
                         params=sum(p.numel() for p in models[1].parameters()))
    return dict(**out, steps=TRAIN_CPU_STEPS, seq=TRAIN_CPU_SEQ,
                batch=TRAIN_CPU_BATCH, tol=TRAIN_CPU_TOL,
                control_lr_scale=TRAIN_CPU_CONTROL_LR)


class FamilyPipeline:
    """TokenPipeline's batches with the inputs of a model that takes more
    than tokens, made on the model's card from seeds: for a config with
    ``embeds_input`` the tokens' rows of a seeded stand-in table (as
    serve_vlm's decode inputs) in place of the tokens; for the audio
    family ``encoder_seq`` frames a row, drawn from a generator seeded by
    the step, so a rerun of a step sees the same frames."""

    def __init__(self, base, model):
        self.base, self.cfg = base, model.cfg
        self.dev, self.dtype = model.device, model.dtype
        self.table = None
        if self.cfg.embeds_input:
            gen = torch.Generator(device=self.dev).manual_seed(1)
            self.table = torch.randn(
                self.cfg.vocab_size, self.cfg.d_model, generator=gen,
                device=self.dev).to(self.dtype)

    @property
    def step(self):
        return self.base.step

    def skip_to(self, step):
        self.base.skip_to(step)

    def next_batch(self):
        cfg, step = self.cfg, self.base.step
        batch = self.base.next_batch()
        if self.table is not None:
            tokens = torch.from_numpy(batch.pop("tokens")).to(self.dev)
            batch["embeds"] = self.table[tokens.long()]
        if cfg.family == "audio":
            gen = torch.Generator(device=self.dev).manual_seed(1000 + step)
            batch["enc_frames"] = torch.randn(
                batch["labels"].shape[0], cfg.encoder_seq, cfg.d_model,
                generator=gen, device=self.dev).to(self.dtype)
        return batch


def family_inputs_np(cfg, batch, step):
    """A TokenPipeline batch with the family's inputs as numpy arrays (the
    card-vs-CPU runs hand both the same): a seeded stand-in table's rows
    in place of the tokens for a config with ``embeds_input``, frames
    seeded by the step for the audio family; token-only batches as they
    are."""
    out = dict(batch)
    if cfg.embeds_input:
        table = np.random.default_rng(1).normal(
            size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
        out["embeds"] = table[out.pop("tokens")]
    if cfg.family == "audio":
        out["enc_frames"] = np.random.default_rng(1000 + step).normal(
            size=(out["labels"].shape[0], cfg.encoder_seq,
                  cfg.d_model)).astype(np.float32)
    return out


def train_trainer(model, ckpt_dir, *, ckpt_every=TRAIN_NO_CKPT,
                  steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    pipe = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                    seq_len=seq, global_batch=batch))
    if model.cfg.embeds_input or model.cfg.family == "audio":
        pipe = FamilyPipeline(pipe, model)
    trainer = Trainer(model, pipe, TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every,
        opt=AdamWConfig(**TRAIN_OPT)), str(ckpt_dir))
    trainer.ckpt.keep_last = 1     # a full-width checkpoint is ~7 GB
    return trainer


def profile_train_step(trainer, step_s, name):
    """One more step under torch.profiler (CPU and CUDA activity, so the
    backward's annotated ranges carry their kernels): device busy, time by
    kernel, and the device time of the flash backward (the recompute in
    torch matmuls), of the embedding's sorted backward and of the MoE's
    ranges, each as a share of the step's device busy time (the flash
    backward's also of its unprofiled time).  Full table in
    build/chip_smoke/profile_train_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(trainer.step + 1)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        raise AssertionError("train: the profiler recorded no device time")
    busy = sum(k[0] for k in kernels) / 1e6

    def ranged(label):
        """Device time of the kernels launched inside the host-side
        ranges named ``label`` (the profiler also shows each range on the
        device's timeline, as an annotation: not counted again)."""
        return sum(ev.device_time_total for ev in prof.events()
                   if ev.name == label
                   and str(ev.device_type).endswith("CPU")) / 1e6

    flash_bwd, embed_bwd = ranged("flash_attention_backward"), ranged(
        "embed_backward")
    # the non-causal flash backward (whisper's encoder and cross-attention);
    # the scan's kernels by their names (launched through ctypes, they are
    # no torch op's children, so its backward's range holds only the torch
    # sums of its partials, added to its kernels)
    flash_nc = ranged("flash_attention_backward_noncausal")

    def named(*parts):
        return sum(k[0] for k in kernels
                   if any(f"::{part}" in k[2] for part in parts)) / 1e6

    scan_fwd = named("scan_chunks", "scan_combine")
    scan_bwd = (named("bwd_local", "bwd_combine", "bwd_grads")
                + ranged("mamba_scan_backward"))
    # the MoE's ranges: the expert products (forward and remat recompute)
    # and the combine's backward
    moe = {label: ranged(label) for label in ("moe_experts",
                                              "moe_combine_backward")}
    prefill = sum(k[0] for k in kernels if "flash_prefill_tc" in k[2]) / 1e6
    text = [smi()] + [f"{us / 1e3:12.4f} ms {c:8d}x  {key}"
                      for us, c, key in kernels]
    path = ROOT / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    (path / f"profile_train_{name}.txt").write_text("\n".join(text) + "\n")
    return dict(
        device_busy_s=busy, unprofiled_step_s=step_s,
        device_busy_share=busy / step_s,
        flash_backward_device_s=flash_bwd,
        flash_backward_share_of_busy=flash_bwd / busy,
        flash_backward_share_of_step=flash_bwd / step_s,
        prefill_tc_device_s=prefill,
        prefill_tc_share_of_busy=prefill / busy,
        embed_backward_device_s=embed_bwd,
        embed_backward_share_of_busy=embed_bwd / busy,
        flash_backward_noncausal_device_s=flash_nc,
        flash_backward_noncausal_share_of_busy=flash_nc / busy,
        mamba_scan_backward_device_s=scan_bwd,
        mamba_scan_backward_share_of_busy=scan_bwd / busy,
        mamba_scan_forward_device_s=scan_fwd,
        mamba_scan_forward_share_of_busy=scan_fwd / busy,
        moe_ranges_device_s=moe,
        moe_ranges_share_of_busy={k: v / busy for k, v in moe.items()},
        top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                     for us, n, key in kernels[:10]])


def embed_grad_cost(dev, cfg, tokens):
    """The embedding's gradient at the main path's shape: the port's sorted
    sum (float32, deterministic) against a float32 index_add_ (held to a
    bf16 rounding of it) and against the gather's own bf16 backward
    (atomics; its error from that sum, and its time): wall ms per call on
    an idle card (the sorted sum syncs once, for the count of distinct
    tokens)."""
    from repro_torch.models.common import embed
    table = torch.zeros(cfg.vocab_size, cfg.d_model, dtype=torch.bfloat16,
                        device=dev, requires_grad=True)
    g = torch.randn(*tokens.shape, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)
                    ).to(torch.bfloat16)
    sorted_g = torch.autograd.grad(embed(table, tokens), table, g)[0]
    want = torch.zeros(table.shape, device=dev).index_add_(
        0, tokens.reshape(-1), g.reshape(-1, cfg.d_model).float())
    torch.testing.assert_close(sorted_g.float(), want, atol=1e-2,
                               rtol=2**-8)
    atomic_g = torch.autograd.grad(table[tokens], table, g)[0]
    return dict(
        sorted_max_abs_err_vs_f32=float((sorted_g.float() - want).abs().max()),
        gather_max_abs_err_vs_f32=float((atomic_g.float() - want).abs().max()),
        sorted_ms=median_ms(lambda: torch.autograd.grad(
            embed(table, tokens), table, g), 10, cover=False),
        gather_atomic_ms=median_ms(lambda: torch.autograd.grad(
            table[tokens], table, g), 10, cover=False),
        rerun_bit_for_bit=bool(torch.equal(sorted_g, torch.autograd.grad(
            embed(table, tokens), table, g)[0])))


def train_fit(dev, cfg, label, extra=None, *, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, per_step=None):
    """Trainer.fit on ``cfg`` in bf16 (random weights, seed 0 on the
    card), TRAIN_STEPS steps of ``batch`` x ``seq`` tokens (the vlm and
    audio families' batches through FamilyPipeline), remat "full": first a
    rerun of step 1 bit for bit; then the losses finite and descending,
    exactly ``per_step`` launches a step (default 2 x layers prefill_tc:
    each layer's forward and its remat recompute) and no other flash
    kernel, step seconds, peak memory and one step profiled.
    ``per_step`` holds prefill_tc's count and, for a Mamba model, the
    scan's forward and backward calls (``mamba_scan``,
    ``mamba_scan_bwd``).  ``extra(trainer, model)`` adds fields before the
    model is freed."""
    import shutil

    from repro_torch.models.model import build
    root = ROOT / "build" / "chip_smoke" / f"train_{label}"
    model = build(cfg, device=dev)
    kw = dict(batch=batch, seq=seq)
    first = train_trainer(model, root / "a", **kw)
    first.init_or_restore()
    first.fit(1)
    snap = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss0 = first.losses[0]
    del first
    main = train_trainer(model, root / "b", **kw)
    main.init_or_restore()
    torch.cuda.synchronize()
    reset_launches()
    main.fit(1)
    rerun_equal = main.losses[0] == loss0 and all(
        torch.equal(p, snap[n]) for n, p in model.named_parameters())
    if not rerun_equal:
        raise AssertionError(f"train {label}: two runs of step 1 differ")
    del snap
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main.fit(TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = list(main.losses)
    if per_step is None:                   # forward and remat recompute
        per_step = dict(prefill_tc=2 * cfg.num_layers)
    per_step = dict(dict(mamba_scan=0, mamba_scan_bwd=0), **per_step)
    expect_launches(f"{label} flash_by_kernel", launches["flash_by_kernel"],
                    dict(prefill_tc=per_step["prefill_tc"] * TRAIN_STEPS,
                         decode_split=0, simt=0))
    expect_launches(f"{label} flash", launches["flash_attention"],
                    per_step["prefill_tc"] * TRAIN_STEPS)
    for name in ("mamba_scan", "mamba_scan_bwd"):
        expect_launches(f"{label} {name}", launches[name],
                        per_step[name] * TRAIN_STEPS)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train {label}: non-finite losses {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"train {label}: losses do not descend: "
                             f"{losses}")
    step_s = main.step_seconds()
    med = statistics.median(step_s[TRAIN_TIMED])
    TRAIN_STEP_S[label] = dict(cfg=cfg, batch=batch, seq=seq, step_s=med)
    prof = profile_train_step(main, med, label)
    more = extra(main, model) if extra else {}
    n_params = model.num_params()
    del main, model
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        arch=cfg.name, params=n_params, dtype=cfg.dtype,
        layers=cfg.num_layers, batch=batch, seq=seq,
        steps=TRAIN_STEPS, opt=TRAIN_OPT, remat=cfg.remat_policy,
        losses=losses, step_s=step_s, step_s_median_3_12=med,
        tokens_per_s=batch * seq / med,
        max_memory_allocated=peak, rerun_bit_for_bit=rerun_equal,
        launches=launches, launches_per_step=dict(
            {k: v for k, v in per_step.items() if v or k == "prefill_tc"},
            decode_split=0, simt=0),
        profile=prof, nvidia_smi=smi(), **more)


def train_main(dev):
    """The main path: train_fit on the full published stablelm-1.6b, and
    the embedding gradient's cost at its batch."""
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH)

    def embed_cost(trainer, model):
        tokens = torch.from_numpy(
            trainer.pipeline.next_batch()["tokens"]).to(dev)
        return dict(embed_grad=embed_grad_cost(dev, cfg, tokens))

    return train_fit(dev, cfg, "main", embed_cost)


def train_restart(dev):
    """Crash and restart at the full width with RESTART_LAYERS layers: an
    uninterrupted run, a run that checkpoints every RESTART_EVERY steps
    and fails at RESTART_FAIL, its restart to RESTART_STEPS; the losses
    after the checkpoint equal the uninterrupted run's bit for bit.  Then
    one asynchronous save of the same state timed: the host snapshot (the
    train loop's wait) and the write."""
    import shutil

    from repro_torch import configs
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.models.model import build
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH),
                              num_layers=RESTART_LAYERS)
    root = ROOT / "build" / "chip_smoke" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)
    model = build(cfg, device=dev)
    ref = train_trainer(model, root / "ref", steps=RESTART_STEPS)
    ref.init_or_restore()
    ref_losses = list(ref.fit())
    del ref
    crash = train_trainer(model, root / "crash", ckpt_every=RESTART_EVERY,
                          steps=RESTART_STEPS)
    crash.init_or_restore()
    try:
        crash.fit(fail_at_step=RESTART_FAIL)
    except RuntimeError as exc:
        if "injected failure" not in str(exc):
            raise
    else:
        raise AssertionError("train restart: the injected failure did not "
                             "happen")
    crash_losses, ckpt_steps = list(crash.losses), crash.ckpt.all_steps()
    del crash
    resumed = train_trainer(model, root / "crash", ckpt_every=RESTART_EVERY,
                            steps=RESTART_STEPS)
    t0 = time.perf_counter()
    start = resumed.init_or_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    resumed_losses = list(resumed.fit())
    if ckpt_steps != [RESTART_EVERY] or start != RESTART_EVERY:
        raise AssertionError(f"train restart: checkpoints {ckpt_steps}, "
                             f"resumed at {start}")
    if (resumed_losses != ref_losses[RESTART_EVERY:]
            or crash_losses != ref_losses[:RESTART_FAIL]):
        raise AssertionError(f"train restart: {crash_losses} then "
                             f"{resumed_losses} against {ref_losses}")
    mgr = CheckpointManager(str(root / "timed"), keep_last=1)
    tree = {"params": resumed.params, "opt": resumed.opt_state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_async(RESTART_STEPS, tree)
    t1 = time.perf_counter()
    mgr.wait()
    t2 = time.perf_counter()
    saved = root / "timed" / f"step_{RESTART_STEPS:08d}"
    nbytes = sum(f.stat().st_size for f in saved.iterdir())
    n_params = model.num_params()
    del resumed, model, tree
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(arch=TRAIN_ARCH, layers=RESTART_LAYERS, params=n_params,
                ckpt_every=RESTART_EVERY, fail_at=RESTART_FAIL,
                steps=RESTART_STEPS, losses_uninterrupted=ref_losses,
                losses_crashed=crash_losses, losses_resumed=resumed_losses,
                bit_for_bit=True, restore_s=restore_s,
                save_snapshot_s=t1 - t0, save_write_s=t2 - t1,
                save_bytes=nbytes)


def train_rwkv(dev):
    """rwkv6-3b at full width with RWKV_TRAIN_LAYERS layers takes
    RWKV_TRAIN_STEPS steps: finite losses, and the RWKV6 kernel launched
    per layer and step for the forward and the remat recompute."""
    import shutil

    from repro_torch import configs
    from repro_torch.models.model import build
    cfg = dataclasses.replace(configs.get("rwkv6-3b"),
                              num_layers=RWKV_TRAIN_LAYERS)
    root = ROOT / "build" / "chip_smoke" / "train_rwkv"
    model = build(cfg, device=dev)
    trainer = train_trainer(model, root, steps=RWKV_TRAIN_STEPS)
    trainer.init_or_restore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = trainer.fit()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = 2 * cfg.num_layers
    expect_launches("rwkv rwkv6", launches["rwkv6"],
                    per_step * RWKV_TRAIN_STEPS)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train rwkv: non-finite losses {losses}")
    step_s = trainer.step_seconds()
    n_params = model.num_params()
    del trainer, model
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(arch="rwkv6-3b", layers=RWKV_TRAIN_LAYERS, params=n_params,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
                step_s=step_s, max_memory_allocated=peak,
                launches=launches["rwkv6"], launches_per_step=per_step)


def phase_train(dev):
    """Training on the card (module docstring, phase ``train``); returns
    the main path's launches per step by kernel."""
    flash = train_flash_checks(dev)
    emit("train", part="flash_trainable", **flash)
    rwkv_ops = train_rwkv6_checks(dev)
    emit("train", part="rwkv6_trainable", **rwkv_ops)
    emit("train", part="card_vs_cpu", **train_card_vs_cpu(dev))
    main = train_main(dev)
    emit("train", part="main", **main)
    emit("train", part="restart", **train_restart(dev))
    rwkv = train_rwkv(dev)
    emit("train", part="rwkv", **rwkv)
    return dict(flash_per_step=main["launches_per_step"],
                flash_main=main["launches"]["flash_by_kernel"],
                rwkv6_per_step_2_layers=rwkv["launches_per_step"],
                rwkv6_run=rwkv["launches"])


# phase train_moe: the MoE family at full width, each with its depth (None:
# the published depth).  deepseek-v2-lite-16b keeps its dense first layer
# and 3 MoE layers: its 27 layers' bf16 weights and gradients and float32
# master, m and v (16 bytes a parameter) would take ~250 GB
TRAIN_MOE = {"granite-moe-1b-a400m": None, "deepseek-v2-lite-16b": 4}
TRAIN_BYTES_PER_PARAM = 16


def phase_train_moe(dev):
    """Training the MoE family on the card (module docstring, phase
    ``train_moe``); returns each run's flash launches per step."""
    from repro_torch import configs
    from repro_torch.models.model import num_params
    out = {}
    for arch, layers in TRAIN_MOE.items():
        full = configs.get(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        res = train_fit(dev, cfg, arch)
        if layers is not None:
            res["reduced"] = dict(
                num_layers=[full.num_layers, layers],
                full_params=num_params(full),
                full_train_state_bytes=TRAIN_BYTES_PER_PARAM
                * num_params(full),
                why="the whole model's bf16 weights and gradients and "
                    "float32 AdamW state exceed one card's 80 GB")
        emit("train_moe", part=arch, **res)
        out[arch if layers is None else f"{arch} ({layers} layers)"] = res[
            "launches_per_step"]["prefill_tc"]
    return out


# phase train_families: the vlm, audio and hybrid families' training at
# published width: (overrides of the published config, batch, sequence).
# whisper-small whole, its decoder at its 448-token text context (batch
# 16, 1500 frames a row); qwen2-vl-7b cut to 8 of 28 layers (no embedding
# table: the lm_head's 0.545e9 parameters plus ~0.233e9 a layer, 2.41e9
# at 8 layers, 38.5 GB of train state at TRAIN_BYTES_PER_PARAM); jamba as
# one period-8 block (7 Mamba layers, 1 attention, 4 MoE) with 2 of its 16
# experts at top-2 (one block with all 16 is ~13e9 parameters, over 200 GB
# of train state): every width stays published (d_model 4096, d_inner
# 8192, N 16, d_conv 4, 32/8 heads), so the scan kernels run at the serve
# path's shape.  JAMBA_TRAIN is the scan's (B, S, D, N) in that run.
TRAIN_FAMILIES = {
    "whisper-small": ({}, 16, 448),
    "qwen2-vl-7b": (dict(num_layers=8), TRAIN_BATCH, TRAIN_SEQ),
    "jamba-v0.1-52b": (dict(num_layers=8, num_experts=2), TRAIN_BATCH,
                       TRAIN_SEQ),
}
JAMBA_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 8192, 16)
# the flash kernels at those train steps' attention shapes (B, Hq, Hkv,
# Sq, Skv, D, causal, kv_len), as FLASH_FAMILIES: whisper-small's encoder
# over its 1500 frames, its decoder's cross-attention and causal self-
# attention over the 448-token text context, at batch 16; qwen2-vl's and
# jamba's causal self-attention at TRAIN_BATCH x TRAIN_SEQ
FLASH_FAMILIES_TRAIN = {
    "whisper_train_encoder": (16, 12, 12, 1500, 1500, 64, False, None),
    "whisper_train_cross": (16, 12, 12, 448, 1500, 64, False, None),
    "whisper_train_self": (16, 12, 12, 448, 448, 64, True, None),
    "qwen2vl_train": (TRAIN_BATCH, 28, 4, TRAIN_SEQ, TRAIN_SEQ, 128, True,
                      None),
    "jamba_train": (TRAIN_BATCH, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True,
                    None),
}
# each of those shapes' train run
FLASH_TRAIN_ARCH = {"whisper": "whisper-small", "qwen2vl": "qwen2-vl-7b",
                    "jamba": "jamba-v0.1-52b"}
TRAIN_FAMILY_WHY = {
    "qwen2-vl-7b": "the whole model's bf16 weights and gradients and "
                   "float32 AdamW state (16 bytes a parameter) exceed one "
                   "card's 80 GB; depth is cut, every width kept",
    "jamba-v0.1-52b": "one period-8 block with all 16 experts is ~13e9 "
                      "parameters, over 200 GB of train state; only the "
                      "experts are cut (top-2 kept), every width kept, so "
                      "the scan kernels run at the serve path's shape",
}


def family_train_launches(cfg):
    """Launches a train step of ``cfg`` makes under remat "full": every
    attention's flash forward and its recompute (prefill_tc in bf16; the
    audio family's encoder self-attention and its decoder's self- and
    cross-attention), every Mamba layer's scan forward and recompute, and
    one scan backward a Mamba layer."""
    if cfg.family == "audio":
        return dict(prefill_tc=2 * (cfg.encoder_layers + 2 * cfg.num_layers))
    if cfg.family != "hybrid":
        return dict(prefill_tc=2 * cfg.num_layers)
    attn = sum(map(cfg.is_attn_layer, range(cfg.num_layers)))
    mamba = cfg.num_layers - attn
    return dict(prefill_tc=2 * attn, mamba_scan=2 * mamba,
                mamba_scan_bwd=mamba)


def phase_train_families(dev):
    """Training the vlm, audio and hybrid families on the card (module
    docstring, phase ``train_families``): the reduced f32 configs card vs
    CPU, then Trainer.fit at TRAIN_FAMILIES; returns each run's launches
    per step."""
    from repro_torch import configs
    from repro_torch.models.model import num_params
    emit("train_families", part="card_vs_cpu",
         **train_card_vs_cpu(dev, TRAIN_CPU_FAMILY_ARCHS))
    out = {}
    for arch, (cut, batch, seq) in TRAIN_FAMILIES.items():
        full = configs.get(arch)
        cfg = dataclasses.replace(full, **cut)
        res = train_fit(dev, cfg, arch, batch=batch, seq=seq,
                        per_step=family_train_launches(cfg))
        if cut:
            res["reduced"] = dict(
                **{k: [getattr(full, k), v] for k, v in cut.items()},
                full_params=num_params(full),
                full_train_state_bytes=TRAIN_BYTES_PER_PARAM
                * num_params(full),
                why=TRAIN_FAMILY_WHY[arch])
        emit("train_families", part=arch, **res)
        out[arch] = res["launches_per_step"]
        out[f"{arch} run"] = {k: res["launches"][k] for k in (
            "flash_by_kernel", "mamba_scan", "mamba_scan_bwd")}
    return out


# ------------------------------------------------------------- autoscaler
# the reference's TestAutoscaler demand: 21 days of hourly history, 2 days
# held out; the card's plan against the CPU's within the free pool's own
# tolerance (of the plan's peak, tests/test_torch_freepool.py)
AUTOSCALER_HIST, AUTOSCALER_FUT = 24 * 21, 24 * 2
AUTOSCALER_TOL = 1e-4
AUTOSCALER_REPS = 5


def autoscaler_demand():
    """(history, future) float32 numpy: base 20, 20% annual growth, noise
    from seed 0."""
    from repro_torch.core import demand as dm
    f = dm.synth_demand(AUTOSCALER_HIST + AUTOSCALER_FUT,
                        dm.DemandConfig(base_level=20.0, annual_growth=0.2),
                        generator=torch.Generator().manual_seed(0)).numpy()
    return f[:AUTOSCALER_HIST], f[AUTOSCALER_HIST:]


def phase_autoscaler(dev):
    """The free-pool autoscaler (module docstring, phase ``autoscaler``)."""
    from repro_torch.serve.autoscaler import (
        AutoscalerConfig,
        FreePoolAutoscaler,
    )
    hist, fut = autoscaler_demand()
    horizon = len(fut)
    card = FreePoolAutoscaler(AutoscalerConfig(), device=dev)
    cpu = FreePoolAutoscaler(AutoscalerConfig(), device="cpu")

    def wall(auto):
        times = []
        for _ in range(AUTOSCALER_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = auto.plan(hist, horizon)
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)

    tc, card_s = wall(card)
    tp, cpu_s = wall(cpu)
    peak = float(np.abs(tp).max())
    tol = AUTOSCALER_TOL * peak
    err = float(np.abs(tc - tp).max())
    if not err <= tol:
        raise AssertionError(f"autoscaler: card plan {err} from the CPU's, "
                             f"tolerance {tol}")
    # the bookkeeping on each plan, tick by tick, up to the first target
    # within the tolerance of an integer (where ceil may differ)
    near = ((np.abs(tc - np.round(tc)) <= tol)
            | (np.abs(tp - np.round(tp)) <= tol))
    a = FreePoolAutoscaler(AutoscalerConfig(), device=dev)
    b = FreePoolAutoscaler(AutoscalerConfig(), device="cpu")
    compared = 0
    for t in range(horizon):
        if near[t]:
            break
        a.step(float(tc[t]), float(fut[t]))
        b.step(float(tp[t]), float(fut[t]))
        if (a.warm, a.pending, a.stats) != (b.warm, b.pending, b.stats):
            raise AssertionError(f"autoscaler: tick {t} card {a.stats} "
                                 f"CPU {b.stats}")
        compared += 1
    pred = FreePoolAutoscaler(AutoscalerConfig(), device=dev)
    pred.run(hist, fut)
    pred_cpu = FreePoolAutoscaler(AutoscalerConfig(), device="cpu")
    pred_cpu.run(hist, fut)
    if not near.any() and pred.stats != pred_cpu.stats:
        raise AssertionError(f"autoscaler: run card {pred.stats} CPU "
                             f"{pred_cpu.stats}")
    low = FreePoolAutoscaler(AutoscalerConfig(), device=dev)
    low.run(hist, fut, static_size=float(np.percentile(hist, 50)))
    high = FreePoolAutoscaler(AutoscalerConfig(), device=dev)
    high.run(hist, fut, static_size=float(hist.max() * 1.2))
    if not (pred.stats.slo_misses < low.stats.slo_misses
            and pred.stats.replica_ticks < high.stats.replica_ticks):
        raise AssertionError(f"autoscaler: predicted {pred.stats}, static "
                             f"p50 {low.stats}, static 1.2 max {high.stats}")
    emit("autoscaler", hours=[AUTOSCALER_HIST, horizon],
         plan_max_abs_err=err, tolerance=tol, plan_peak=peak,
         plan_card_s=card_s, plan_cpu_s=cpu_s,
         near_integer_ticks=int(near.sum()), ticks_compared=compared,
         stats_equal_run=bool(pred.stats == pred_cpu.stats),
         predicted=dataclasses.asdict(pred.stats),
         static_p50=dataclasses.asdict(low.stats),
         static_1_2_max=dataclasses.asdict(high.stats))


# ------------------------------------------------------- compressed training
# phase train_compressed: phase train's main path (stablelm-1.6b, bf16,
# 4 x 2048 tokens, AdamW at TRAIN_OPT) as the compressed step over a
# one-rank "pod" mesh (NCCL), from the plain step's init and batches
COMPRESSED_STEPS = 4
COMPRESSED_TIMED = slice(1, COMPRESSED_STEPS)       # steps 2-4 (1-based)
# bytes the sync moves per parameter (the expectation printed beside its
# time, not a gate): two passes reading g (bf16) and e, then q, the int32
# payload, the new error and the average
SYNC_BYTES_PER_PARAM = 26


def compressed_sync_check(real, out):
    """A stand-in for ``compression.compressed_pod_sync`` that runs it and,
    on its first call, holds every leaf to the sync's algebra: with
    x = g + e_old and s the leaf's shared scale (the max of |x| over its
    stacked leaf, over 127), |g_avg - x| <= s / 2 plus one ulp of g_avg in
    g's dtype, and x = g_avg + e_new within the rounding of the cast to
    g's dtype and of float32.  The worst ratios go into ``out``."""
    from repro_torch.train import compression

    def sync(grads, err_state, mesh, scale_groups=None):
        new_g, new_e = real(grads, err_state, mesh, scale_groups)
        if out:
            return new_g, new_e
        keys = [scale_groups[n] for n in grads]
        amax: dict[str, float] = {}
        for (n, g), k in zip(grads.items(), keys):
            m = float((g.float() + err_state[n]).abs().amax())
            amax[k] = max(amax.get(k, 0.0), m)
        worst_dev = worst_sum = 0.0
        for (n, g), k in zip(grads.items(), keys):
            s = float(compression._scale(torch.tensor(amax[k])))
            eps = torch.finfo(g.dtype).eps
            x = g.float() + err_state[n]
            ga = new_g[n].float()
            dev_ = (ga - x).abs()
            bound = s / 2 * (1 + 2**-22) + eps * ga.abs()
            gap = (x.double() - ga.double() - new_e[n].double()).abs()
            bound2 = eps * ga.abs().double() + 2**-22 * x.abs().double()
            if not (bool((dev_ <= bound).all())
                    and bool((gap <= bound2).all())):
                raise AssertionError(
                    f"train_compressed: leaf {n}: |g_avg - x| "
                    f"{float(dev_.max())} (scale {s}), |x - g_avg - e_new| "
                    f"{float(gap.max())}")
            worst_dev = max(worst_dev, float(dev_.max()) / s)
            worst_sum = max(worst_sum, float((gap / bound2.clamp_min(
                1e-30)).max()))
        out.update(leaves=len(grads), scale_groups=len(amax),
                   max_dev_over_scale=worst_dev,
                   max_sum_gap_over_bound=worst_sum,
                   nonzero_error_leaves=sum(
                       bool(e.any()) for e in new_e.values()))
        return new_g, new_e

    return sync


def sync_device_ms(step, state, batch):
    """One more step under torch.profiler: the device ms of the kernels
    under the ``ef_int8_sync`` range, and the step's device busy ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step(*state, batch)
        torch.cuda.synchronize()
    sync = sum(ev.device_time_total for ev in prof.events()
               if ev.name == "ef_int8_sync"
               and str(ev.device_type).endswith("CPU")) / 1e3
    busy = sum(k[0] for k in device_kernels(prof)) / 1e3
    return sync, busy, list(out[1:])


def phase_train_compressed(dev):
    """The compressed train step (module docstring, phase
    ``train_compressed``); returns its prefill_tc launches a step."""
    import shutil
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models.model import build
    from repro_torch.train import compression
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (
        build_compressed_train_step,
        build_train_step,
        init_train_state,
    )
    cfg = configs.get(TRAIN_ARCH)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    batches = [pipe.next_batch() for _ in range(COMPRESSED_STEPS)]
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    model = build(cfg, device=dev)

    def fresh():
        return list(init_train_state(
            model, torch.Generator(device=dev).manual_seed(0)))

    def run(step, state):
        losses, secs, flash = [], [], []
        for batch in batches:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*state, batch)
            losses.append(float(out[0]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            flash.append(read_launches()["flash_by_kernel"])
            state = list(out[1:])
        return losses, secs, flash, state

    plain_losses, plain_s, plain_flash, state = run(
        build_train_step(model, opt_cfg), fresh())
    del state
    torch.cuda.empty_cache()

    root = ROOT / "build" / "chip_smoke" / "train_compressed"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root / 'pg'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    try:
        mesh = make_pod_mesh(1)
        checks: dict = {}
        real = compression.compressed_pod_sync
        compression.compressed_pod_sync = compressed_sync_check(real, checks)
        try:
            step = build_compressed_train_step(model, mesh, opt_cfg)
        finally:
            compression.compressed_pod_sync = real
        params, opt = fresh()
        err = compression.init_error_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, flash, state = run(step, [params, opt, err])
        peak = torch.cuda.max_memory_allocated()
        err_bytes = sum(e.numel() * e.element_size()
                        for e in state[2].values())
        snap = {n: p.detach().clone() for n, p in model.named_parameters()}
        del state, params, opt, err
        params, opt = fresh()
        rerun, _, _, state = run(step, [params, opt,
                                        compression.init_error_state(params)])
        rerun_equal = rerun == losses and all(
            torch.equal(p, snap[n]) for n, p in model.named_parameters())
        del snap
        sync_ms, busy_ms, state = sync_device_ms(step, state, batches[0])
        host_route = nccl_host_route(dev, root)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    n_params = model.num_params()
    del model, state
    torch.cuda.empty_cache()

    per_step = 2 * cfg.num_layers          # forward and remat recompute
    want = dict(prefill_tc=per_step, decode_split=0, simt=0)
    for label, got in (("plain", plain_flash), ("compressed", flash)):
        if any(f != want for f in got):
            raise AssertionError(f"train_compressed: {label} launches a "
                                 f"step {got}, expected {want}")
    if losses[0] != plain_losses[0]:
        raise AssertionError(f"train_compressed: step 1 loss {losses[0]} "
                             f"against the plain step's {plain_losses[0]}")
    if not checks:
        raise AssertionError("train_compressed: the sync never ran")
    if not (np.isfinite(losses).all() and np.isfinite(plain_losses).all()):
        raise AssertionError(f"train_compressed: losses {losses}, plain "
                             f"{plain_losses}")
    if not rerun_equal:
        raise AssertionError(f"train_compressed: a rerun differs: {rerun} "
                             f"against {losses}")
    step_s = statistics.median(secs[COMPRESSED_TIMED])
    step_plain = statistics.median(plain_s[COMPRESSED_TIMED])
    peaks = PEAKS["pcie" if "PCIe" in torch.cuda.get_device_name(0)
                  else "sxm"]
    sync_bytes = SYNC_BYTES_PER_PARAM * n_params
    emit("train_compressed", arch=cfg.name, params=n_params,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=COMPRESSED_STEPS,
         mesh={"pod": 1}, backend="nccl", losses=losses,
         plain_losses=plain_losses, step1_loss_equal=True,
         step_s=secs, plain_step_s=plain_s, step_s_median_2_4=step_s,
         plain_step_s_median_2_4=step_plain,
         sync_device_ms=sync_ms, step_device_busy_ms=busy_ms,
         sync_share_of_step=sync_ms / 1e3 / step_s,
         sync_bytes_expected=sync_bytes,
         sync_bound_ms=sync_bytes / peaks["bytes"] * 1e3,
         error_state_bytes=err_bytes, max_memory_allocated=peak,
         launches_per_step=want, rerun_bit_for_bit=True, sync_check=checks,
         nccl_host_route=host_route, nvidia_smi=smi())
    return want


def nccl_host_route(dev, root):
    """The host route of the multi-rank pieces under an NCCL default group
    (world 1): ``launch.mesh.host_group`` made once and kept, a row
    exchange (``gather_rows``), and a placed bfloat16 leaf saved (gathered
    over the host group) and restored onto its mesh, bit for bit."""
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import placement
    group = mesh_mod.host_group()
    if group is None or mesh_mod.host_group() is not group:
        raise AssertionError("train_compressed: no host group kept under "
                             f"{dist.get_backend()}")
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    if mesh_mod.gather_rows(rows, 4) is not rows:
        raise AssertionError("train_compressed: gather_rows at world 1 is "
                             "not the identity")
    mesh = mesh_mod.make_mesh({"data": 1}, device=dev)
    sh = (mesh, placement.placements_for(("data", None), mesh))
    full = torch.randn(256, 128, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
    mgr = CheckpointManager(str(root / "ckpt"))
    mgr.save(1, placement.place({"w": full}, {"w": sh}))
    if mesh_mod.host_group() is not group:
        raise AssertionError("train_compressed: a save made a host group")
    got, _ = mgr.restore(1, {"w": full.to("meta")}, shardings={"w": sh})
    same_bits("train_compressed: placed leaf", got["w"].to_local(), full)
    return dict(default_backend=dist.get_backend(),
                host_group_backend=dist.get_backend(group),
                placed_leaf_bit_for_bit=True, gather_rows_identity=True)


# ------------------------------------------------------------------ cells
# phase cells: the meta-device byte count of what a phase builds on the
# card (parameters, AdamW state, cache) against the card's allocations:
# the requested bytes exactly, the allocated bytes within the caching
# allocator's 512-byte rounding per tensor
ALLOC_ROUND = 512
CELLS_CARD = {
    "train": ("stablelm-1.6b", {}, True, None),
    "serve_int8": ("internlm2-20b", {"kv_cache_dtype": "int8"}, False,
                   (SERVE_SLOTS, SERVE_CACHE)),
    "serve_hybrid": ("jamba-v0.1-52b", {"num_layers": HYBRID_LAYERS}, False,
                     (SERVE_SLOTS, SERVE_CACHE)),
}


def built_tensors(cfg, device, opt, cache):
    """(model, every tensor a phase allocates for it on ``device``): the
    parameters, with ``opt`` AdamW's master, m and v, with ``cache`` the
    engine's cache of (slots, length)."""
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import init_opt_state
    model = build(cfg, device=device)
    out = list(model.parameters())
    if opt:
        st = init_opt_state(dict(model.named_parameters()))
        out += [t for key in ("master", "m", "v") for t in st[key].values()]
    if cache:
        out += list(model.init_cache(*cache).values())
    return model, out


def requested_bytes():
    return torch.cuda.memory_stats().get("requested_bytes.all.current")


def meta_vs_card(dev, name, arch, cut, opt, cache):
    """One phase's build on the meta device and on the card (module
    docstring, phase ``cells``)."""
    from repro_torch import configs
    from repro_torch.launch.cells import Cell, resolve_rules
    from repro_torch.models.config import ShapeCell
    from repro_torch.sharding.rules import RULESETS
    cfg = dataclasses.replace(configs.get(arch), **cut)
    meta, tensors = built_tensors(cfg, "meta", opt, cache)
    sizes = [t.numel() * t.element_size() for t in tensors]
    meta_bytes = sum(sizes)
    rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in sizes)
    # the dry run's count of the same build on one device
    kind = "train" if opt else "decode"
    shape = ShapeCell(name, kind, cache[1] if cache else TRAIN_SEQ,
                      cache[0] if cache else TRAIN_BATCH)
    cell = Cell(arch=arch, shape=name, cfg=cfg, cell=shape, model=meta)
    counted = cell.device_bytes({}, resolve_rules(dict(RULESETS[kind]), {},
                                                  shape.global_batch))
    dry = sum(counted.values())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), requested_bytes()
    model, card = built_tensors(cfg, dev, opt, cache)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - a0
    requested = None if r0 is None else requested_bytes() - r0
    del model, card
    torch.cuda.empty_cache()
    if dry != meta_bytes:
        raise AssertionError(f"cells {name}: the dry run counts {dry} "
                             f"bytes, the meta build {meta_bytes}")
    if requested is not None and requested != meta_bytes:
        raise AssertionError(f"cells {name}: requested {requested} bytes, "
                             f"meta {meta_bytes}")
    if not 0 <= grown - meta_bytes <= ALLOC_ROUND * len(sizes):
        raise AssertionError(f"cells {name}: allocated {grown} bytes for "
                             f"{len(sizes)} tensors of {meta_bytes} (512-"
                             f"rounded {rounded})")
    return dict(arch=arch, cut=cut, tensors=len(sizes),
                meta_bytes=meta_bytes, dryrun_bytes=dry,
                dryrun_parts=counted, rounded_512=rounded,
                allocated_growth=grown, requested_growth=requested,
                allocated_minus_meta=grown - meta_bytes)


def phase_cells(dev):
    """The dry run of the shape cells on the meta device and its byte count
    against the card (module docstring, phase ``cells``)."""
    import shutil

    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.cells import all_cells
    from repro_torch.models.model import build
    from repro_torch.models.params import named_specs
    out = ROOT / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    records, failures = dryrun.run_all(all_cells(), [False, True], str(out),
                                       verbose=False)
    dry_s = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    if failures or len(records) != 64:
        raise AssertionError(f"cells: dry run failures {failures}")
    rows = [[r["arch"], r["shape"], r["chips"],
             r["memory"]["total_per_device"], r["memory"]["fits"],
             r["roofline"]["compute_s"], r["roofline"]["memory_s"],
             r["roofline"]["dominant"]] for r in records]
    fits = sum(r["memory"]["fits"] for r in records)
    card = {name: meta_vs_card(dev, name, *spec)
            for name, spec in CELLS_CARD.items()}
    # model FLOPs a step of each train_fit run beside its step seconds
    peak = rf.peaks_for(torch.cuda.get_device_name(0))["bf16_flops"]
    mfu = {}
    for label, run in TRAIN_STEP_S.items():
        cfg = run["cfg"]
        flops = 6.0 * rf.active_params(
            cfg, named_specs(build(cfg, device="meta"))) * run["batch"] \
            * run["seq"]
        mfu[label] = dict(arch=cfg.name, layers=cfg.num_layers,
                          model_flops_per_step=flops, step_s=run["step_s"],
                          share_of_bf16_peak=flops / run["step_s"] / peak)
    emit("cells", cells=len(records), dry_run_s=dry_s, fit=fits,
         budget_bytes=records[0]["memory"]["budget_bytes"],
         rows_columns=["arch", "shape", "chips", "bytes_per_device", "fits",
                       "compute_s", "memory_s", "dominant"],
         rows=rows, meta_vs_card=card, train_model_flops=mfu,
         nvidia_smi=smi())


def flash_flops_bytes(b, h, sq, kv_lens, d, elem_bytes, causal, dv=None,
                      hkv=None):
    """Products (QK^T over head dim d, PV over dv, default d; 2 flops per
    multiply-add) over the keys each of the h query heads' rows attends
    to, and each input read and output written once (K/V of the hkv kv
    heads, default h, only up to each row's kv_len)."""
    dv = d if dv is None else dv
    hkv = h if hkv is None else hkv
    keys = 0
    for n in kv_lens:
        if causal:  # query i sees n - sq + i + 1 keys
            keys += sum(n - sq + i + 1 for i in range(sq))
        else:
            keys += sq * n
    flops = 2 * h * (d + dv) * keys
    kv_read = hkv * (d + dv) * sum(kv_lens) * elem_bytes
    nbytes = kv_read + b * h * sq * (d + dv) * elem_bytes
    return flops, nbytes


def linrec_flops_bytes(b, h, t, d):
    """The chunked form's arithmetic per (batch, head, chunk of L = 32):
    r.S, the strictly causal (L, L, dk) decay sum (exp, two multiplies and
    an add per term), att @ v, the bonus and the state update; bytes: r, k,
    v, logw read and y written once, float32, plus the state in and out."""
    L = 32
    chunks = -(-t // L)
    per_chunk = (2 * L * d * d + 4 * (L * (L - 1) // 2) * d
                 + 2 * (L * (L - 1) // 2) * d + 3 * L * d + 2 * L * d * d)
    flops = b * h * chunks * per_chunk
    nbytes = 4 * (5 * b * h * t * d + 2 * b * h * d * d)
    return flops, nbytes


def time_turns(kernel, plain, kernel_reps=25, plain_reps=5):
    """plain, kernel, kernel, plain: both measured in turns on one card;
    returns (kernel ms, plain ms, the kernel's two sets, the plain's)."""
    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    plain_a = median_ms(plain, plain_reps)
    kern_a = median_ms(kernel, kernel_reps)
    kern_b = median_ms(kernel, kernel_reps)
    plain_b = median_ms(plain, plain_reps)
    return (statistics.median([kern_a, kern_b]), (plain_a + plain_b) / 2,
            [kern_a, kern_b], [plain_a, plain_b])


def library_ms(fn, reps=25):
    fn()
    torch.cuda.synchronize()
    return median_ms(fn, reps)


def bound(flops, nbytes, flops_peak, peak):
    t_ops, t_bytes = flops / flops_peak, nbytes / peak["bytes"]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def host_ms(fn, calls=50):
    """Host milliseconds per call of fn(): calls enqueued back to back on
    the host clock, none waiting for the card (the queue holds them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def flash_timed(kernel, plain, library, flops, nbytes, flops_peak, peak):
    """One flash kernel at its routed main shape: device ms (kernel and
    plain in turns, the library call), the bound, and the host's share:
    host ms per call, and ms per call between events on an idle card
    (dispatch and run), for the kernel's wrapper and the library call."""
    ms, plain_ms, kern_sets, plain_sets = time_turns(kernel, plain)
    ms_bound, by = bound(flops, nbytes, flops_peak, peak)
    return dict(ms=ms, plain_ms=plain_ms, kernel_ms=kern_sets,
                plain_ms_sets=plain_sets, library_ms=library_ms(library),
                bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                bound_bytes=nbytes, host_ms=host_ms(kernel),
                library_host_ms=host_ms(library),
                idle_call_ms=median_ms(kernel, 25, cover=False),
                library_idle_call_ms=median_ms(library, 25, cover=False))


def sdpa_backend(q, k, v, **kw):
    """The backend scaled_dot_product_attention takes for these inputs
    (flash, memory-efficient, cuDNN or the math path): the dispatcher's
    own choice, ``torch._fused_sdp_choice``, by its SDPBackend name."""
    from torch.nn.attention import SDPBackend
    names = {int(b): name for name, b in SDPBackend.__members__.items()}
    return names[torch._fused_sdp_choice(q, k, v, **kw)]


def timing_flash(dev, peak):
    """Each flash kernel at the main shape its route serves, with its
    plain version and scaled_dot_product_attention in the same call:
    prefill_tc at the bf16 prefill and at MLA's two prefill shapes
    (FLASH_MLA, with the backend SDPA took there), decode_split at the bf16
    decode, simt at the same prefill in float32 (the reduced models'
    dtype) and at head dim 128 (a shape no main path gives it, timed for
    ranking); the bounds from this run's inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, s, _ = FLASH_PREFILL
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = {}
    for name, dtype, elem, flops_peak, d in (
            ("prefill_tc", torch.bfloat16, 2, peak["bf16_flops"], 64),
            ("simt", torch.float32, 4, peak["fp32_flops"], 64),
            ("simt_d128", torch.float32, 4, peak["fp32_flops"], 128)):
        q, k, v = flash_inputs(dev, dtype, b, h, h, s, s, d, 20,
                               layout="bshd")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        assert fk.route(dtype, d, s) == name.removesuffix("_d128")
        flops, nbytes = flash_flops_bytes(b, h, s, [s] * b, d, elem, True)
        out[name] = flash_timed(
            lambda: fk.flash_attention_cuda(
                q, k, v, lens, causal=True, scale=d ** -0.5, seq_dim=1),
            lambda: attention_ref(qt, kt, vt, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            flops, nbytes, flops_peak, peak)
        del q, k, v, qt, kt, vt
    # prefill_tc at the train step's shape: every layer's forward and
    # remat recompute (phase train)
    bt = TRAIN_BATCH
    q, k, v = flash_inputs(dev, torch.bfloat16, bt, h, h, s, s, 64, 21,
                           layout="bshd")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lens_t = torch.full((bt,), s, dtype=torch.int32, device=dev)
    flops, nbytes = flash_flops_bytes(bt, h, s, [s] * bt, 64, 2, True)
    out["prefill_tc_train"] = flash_timed(
        lambda: fk.flash_attention_cuda(
            q, k, v, lens_t, causal=True, scale=64 ** -0.5, seq_dim=1),
        lambda: attention_ref(qt, kt, vt, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        flops, nbytes, peak["bf16_flops"], peak)
    del q, k, v, qt, kt, vt

    for name, (b, h, s, d, dv) in (*FLASH_MLA.items(),
                                   *FLASH_MOE_TRAIN.items()):
        q, k, v = flash_inputs(dev, torch.bfloat16, b, h, h, s, s, d, 22,
                               layout="bshd", dv=dv)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        assert fk.route(torch.bfloat16, d, s, dv=dv) == "prefill_tc"
        lens_m = torch.full((b,), s, dtype=torch.int32, device=dev)
        flops, nbytes = flash_flops_bytes(b, h, s, [s] * b, d, 2, True, dv)
        out[name] = flash_timed(
            lambda: fk.flash_attention_cuda(
                q, k, v, lens_m, causal=True, scale=d ** -0.5, seq_dim=1),
            lambda: attention_ref(qt, kt, vt, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            flops, nbytes, peak["bf16_flops"], peak)
        out[name]["library_backend"] = sdpa_backend(qt, kt, vt,
                                                    is_causal=True)
        del q, k, v, qt, kt, vt

    # prefill_tc at serve_int8's longest prompt (GQA 48/8 at D 128)
    b, hq, hkv, s, d = FLASH_INTERNLM2_PREFILL
    q, k, v = flash_inputs(dev, torch.bfloat16, b, hq, hkv, s, s, d, 24,
                           layout="bshd")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    assert fk.route(torch.bfloat16, d, s) == "prefill_tc"
    lens_i = torch.full((b,), s, dtype=torch.int32, device=dev)
    flops, nbytes = flash_flops_bytes(b, hq, s, [s] * b, d, 2, True, hkv=hkv)
    out["prefill_tc_internlm2"] = flash_timed(
        lambda: fk.flash_attention_cuda(
            q, k, v, lens_i, causal=True, scale=d ** -0.5, seq_dim=1),
        lambda: attention_ref(qt, kt, vt, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        flops, nbytes, peak["bf16_flops"], peak)
    out["prefill_tc_internlm2"]["library_backend"] = sdpa_backend(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    del q, k, v, qt, kt, vt

    dq, dk, dv, kv_len = decode_inputs(dev)
    dqt, dkt, dvt = (x.transpose(1, 2) for x in (dq, dk, dv))
    keep = (torch.arange(SERVE_CACHE, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    bsl, hd, dd = FLASH_DECODE
    assert fk.route(dq.dtype, dd, 1) == "decode_split"
    dflops, dbytes = flash_flops_bytes(bsl, hd, 1, kv_len.tolist(), dd, 2,
                                       True)
    out["decode_split"] = flash_timed(
        lambda: fk.flash_attention_cuda(
            dq, dk, dv, kv_len, causal=True, scale=dd ** -0.5, seq_dim=1),
        lambda: attention_ref(dqt, dkt, dvt, causal=True, kv_len=kv_len),
        lambda: F.scaled_dot_product_attention(dqt, dkt, dvt,
                                               attn_mask=keep),
        dflops, dbytes, peak["bf16_flops"], peak)
    out.update(timing_decode_int8(dev, peak))
    return out


def timing_decode_int8(dev, peak):
    """decode_split at internlm2-20b's decode (int8_main_inputs): the
    int8 instance over the quantized cache (its bound: the int8 values and
    bf16 scales up to each row's kv_len, q read and o written once), held
    by int8_decode_check on these inputs, and the bf16 instance over the
    bf16 cache, held to its plain version, each timed beside its plain
    version; no PyTorch call reads an int8 cache, so the int8 row's
    library time is null, and SDPA over the bf16 cache stands beside both
    for context."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import (
        attention_int8_ref,
        attention_ref,
    )
    b, hq, hkv, d = FLASH_INT8_DECODE
    q, k, v, kq, ks, vq, vs, kv_len = int8_main_inputs(dev)
    int8_err, _ = int8_decode_check("timing int8 decode", q, kq, ks, vq, vs,
                                    kv_len, FLASH_BF16)
    qt, kt, vt, kqt, vqt, kst, vst = (x.transpose(1, 2)
                                      for x in (q, k, v, kq, vq, ks, vs))
    keep = (torch.arange(SERVE_CACHE, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    scale = d ** -0.5
    bf16_err, _ = flash_compare(
        "timing bf16 decode",
        fk.flash_attention_cuda(q, k, v, kv_len, causal=True, scale=scale,
                                seq_dim=1).transpose(1, 2),
        attention_ref(qt, kt, vt, causal=True, kv_len=kv_len), FLASH_BF16)
    flops, nbytes = flash_flops_bytes(b, hq, 1, kv_len.tolist(), d, 2, True,
                                      hkv=hkv)
    sdpa = flash_timed(
        lambda: fk.flash_attention_cuda(q, k, v, kv_len, causal=True,
                                        scale=scale, seq_dim=1),
        lambda: attention_ref(qt, kt, vt, causal=True, kv_len=kv_len),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                               enable_gqa=True),
        flops, nbytes, peak["bf16_flops"], peak)
    sdpa["max_abs_err"] = bf16_err
    int8_bytes = (hkv * sum(kv_len.tolist()) * 2 * (d + 2)
                  + b * hq * 2 * d * 2)

    def int8_kernel():
        fk.flash_attention_cuda(q, kq, vq, kv_len, causal=True, scale=scale,
                                seq_dim=1, k_scale=ks, v_scale=vs)

    ms, plain_ms, kern_sets, plain_sets = time_turns(
        int8_kernel, lambda: attention_int8_ref(qt, kqt, vqt, kst, vst,
                                                causal=True, kv_len=kv_len))
    ms_bound, by = bound(flops, int8_bytes, peak["bf16_flops"], peak)
    int8 = dict(max_abs_err=int8_err, ms=ms, plain_ms=plain_ms,
                kernel_ms=kern_sets,
                plain_ms_sets=plain_sets, library_ms=None,
                library_context_ms=sdpa["library_ms"],
                library_context="scaled_dot_product_attention over the "
                                "bf16 cache",
                bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                bound_bytes=int8_bytes, host_ms=host_ms(int8_kernel),
                library_host_ms=None,
                bf16_instance_ms=sdpa["ms"],
                bf16_bound_ms=sdpa["bound_ms"],
                ms_over_bf16_ms=ms / sdpa["ms"],
                bound_over_bf16_bound=ms_bound / sdpa["bound_ms"])
    return {"decode_split_internlm2": sdpa, "decode_split_int8": int8}


def timing_linrec(dev, peak):
    """The RWKV6 call (three kernels) and its plain version at the main
    shape, and at a short prompt's length; then the call at each of
    serve_rwkv's prompt lengths, summed over rwkv6-3b's layers: the RWKV6
    device time of one serve run (one call per layer and request) and its
    bound.  Bounds from the work."""
    from repro_torch import configs
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.linrec.ref import rwkv6_chunked_ref
    out = {}
    for label, (b, h, t, d) in (("main", LINREC_MAIN),
                                ("short", LINREC_SHORT),
                                ("train", (TRAIN_BATCH, *LINREC_MAIN[1:]))):
        r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, 10,
                                             layout="bthd")
        rt, kt, vt, lt = (x.transpose(1, 2) for x in (r, k, v, logw))
        ms, plain_ms, kern_sets, plain_sets = time_turns(
            lambda: lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1),
            lambda: rwkv6_chunked_ref(rt, kt, vt, lt, u, s0), plain_reps=3)
        flops, nbytes = linrec_flops_bytes(b, h, t, d)
        ms_bound, by = bound(flops, nbytes, peak["fp32_flops"], peak)
        out[label] = dict(shape=[b, h, t, d], ms=ms, plain_ms=plain_ms,
                          kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                          bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                          bound_bytes=nbytes)
    cfg = configs.get("rwkv6-3b")
    h, d = cfg.rwkv_heads, cfg.rwkv_head_size
    run_ms = run_bound = 0.0
    for t in serve_prompt_lengths()[0].tolist():
        r, k, v, logw, u, s0 = linrec_inputs(dev, 1, h, t, d, 10,
                                             layout="bthd")
        def call():
            lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1)
        call()
        torch.cuda.synchronize()
        run_ms += cfg.num_layers * median_ms(call, 10)
        run_bound += cfg.num_layers * bound(
            *linrec_flops_bytes(1, h, t, d), peak["fp32_flops"], peak)[0]
    out["serve_run"] = dict(calls=cfg.num_layers * SERVE_REQUESTS,
                            ms=run_ms, bound_ms=run_bound)
    return out


def mamba_flops_bytes(b, s, d, n):
    """MAMBA_OPS operations per (step, channel, state); delta, x and y
    once, bm, cm, a, h0 and the final h once, float32."""
    return (MAMBA_OPS * b * s * d * n,
            4 * (3 * b * s * d + 2 * b * s * n + d * n + 2 * b * d * n))


def mamba_bwd_flops_bytes(b, s, d, n, dh_final=False):
    """MAMBA_BWD_OPS operations per (step, channel, state); the function's
    inputs (delta, x, dy; bm, cm; a; h0, and dh_final where it is given)
    read once and its outputs (ddelta, dx; dbm, dcm; da; dh0) written
    once, float32.  The kernel's own residual, the chunk-start states, is
    not counted: only h0 among them is an input of the function."""
    return (MAMBA_BWD_OPS * b * s * d * n,
            4 * (5 * b * s * d + 4 * b * s * n + 2 * d * n
                 + (3 if dh_final else 2) * b * d * n))


def timing_mamba(dev, peak):
    """The Mamba scan and its plain step loop at jamba's longest prefill
    (MAMBA_MAIN), in turns; then the kernel at each of serve_hybrid's prompt
    lengths, summed over its Mamba layers: the scan's device time in one
    serve run and its bound.  At jamba's train step (JAMBA_TRAIN): the
    forward, and the backward beside mamba_scan_bwd_ref in turns."""
    from repro_torch import configs
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bwd_ref,
        mamba_scan_ref,
    )
    b, s, d, n = MAMBA_MAIN
    args = mamba_inputs(dev, b, s, d, n, 60)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: mk.mamba_scan_cuda(*args), lambda: mamba_scan_ref(*args),
        plain_reps=2)
    flops, nbytes = mamba_flops_bytes(b, s, d, n)
    ms_bound, by = bound(flops, nbytes, peak["fp32_flops"], peak)
    cfg = dataclasses.replace(configs.get("jamba-v0.1-52b"),
                              num_layers=HYBRID_LAYERS)
    layers = cfg.num_layers - sum(map(cfg.is_attn_layer,
                                      range(cfg.num_layers)))
    run_ms = run_bound = 0.0
    for t in serve_prompt_lengths()[0].tolist():
        call_args = mamba_inputs(dev, 1, t, d, n, 61)

        def call():
            mk.mamba_scan_cuda(*call_args)
        call()
        torch.cuda.synchronize()
        run_ms += layers * median_ms(call, 10)
        run_bound += layers * bound(*mamba_flops_bytes(1, t, d, n),
                                    peak["fp32_flops"], peak)[0]
    del args
    # jamba's train step: the forward (with its chunk-start states, as the
    # trainable op calls it) and the backward
    tb, ts, td, tn = JAMBA_TRAIN
    targs = mamba_inputs(dev, tb, ts, td, tn, 62)
    gen = torch.Generator(device=dev).manual_seed(63)
    dy = torch.randn(tb, ts, td, generator=gen, device=dev)
    _, _, states = mk.mamba_scan_cuda(*targs)
    train_fwd_ms = library_ms(lambda: mk.mamba_scan_cuda(*targs))
    train_fwd_bound = bound(*mamba_flops_bytes(tb, ts, td, tn),
                            peak["fp32_flops"], peak)
    bwd_ms, bwd_plain_ms, bwd_sets, bwd_plain_sets = time_turns(
        lambda: mk.mamba_scan_bwd_cuda(*targs[:5], dy, states),
        lambda: mamba_scan_bwd_ref(*targs, dy), plain_reps=1)
    bwd_flops, bwd_bytes = mamba_bwd_flops_bytes(tb, ts, td, tn)
    bwd_bound, bwd_by = bound(bwd_flops, bwd_bytes, peak["fp32_flops"], peak)
    # both kernels held to their plain versions at the train shape too
    train_errs = {}
    for label, got, want, tol in (
            *zip(("y", "h"), mk.mamba_scan_cuda(*targs),
                 mamba_scan_ref(*targs), (MAMBA_TOL,) * 2),
            *zip(("ddelta", "dx", "da", "dbm", "dcm", "dh0"),
                 mk.mamba_scan_bwd_cuda(*targs[:5], dy, states),
                 mamba_scan_bwd_ref(*targs, dy), (MAMBA_BWD_TOL,) * 6)):
        err, big = float((got - want).abs().max()), float(want.abs().max())
        if not err <= tol * big:
            raise AssertionError(f"mamba at {JAMBA_TRAIN} {label}: {err} > "
                                 f"{tol} x {big}")
        train_errs[label] = dict(max_abs_err=err, largest=big)
    return dict(shape=[b, s, d, n], ms=ms,
                plain_ms=plain_ms,
                kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                bound_bytes=nbytes, exponentials=b * s * d * n,
                share_of_bound=ms_bound / ms,
                serve_run=dict(calls=layers * SERVE_REQUESTS, ms=run_ms,
                               bound_ms=run_bound),
                train=dict(shape=list(JAMBA_TRAIN), forward_ms=train_fwd_ms,
                           forward_bound_ms=train_fwd_bound[0],
                           forward_bound_by=train_fwd_bound[1],
                           errors=train_errs),
                backward=dict(shape=list(JAMBA_TRAIN), ms=bwd_ms,
                              kernel_ms=bwd_sets, plain_ms=bwd_plain_ms,
                              plain_ms_sets=bwd_plain_sets,
                              bound_ms=bwd_bound, bound_by=bwd_by,
                              bound_flops=bwd_flops, bound_bytes=bwd_bytes,
                              share_of_bound=bwd_bound / bwd_ms))


def timing_families_flash(dev, peak):
    """The flash kernels at FLASH_FAMILIES's and FLASH_FAMILIES_TRAIN's
    shapes, each with its plain
    version and scaled_dot_product_attention (and the backend it took)
    in the same call: the encoder and cross-attention non-causal without
    a mask, the decodes with a boolean mask of each row's kv_len, GQA by
    enable_gqa; bounds from this run's inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    out = {}
    for i, (key, case) in enumerate({**FLASH_FAMILIES,
                                     **FLASH_FAMILIES_TRAIN}.items()):
        b, hq, hkv, sq, skv, d, causal, _ = case
        q, k, v, lens = family_flash_inputs(dev, case, 30 + i)
        full = (lens if lens is not None
                else torch.full((b,), skv, dtype=torch.int32, device=dev))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = dict(enable_gqa=hq != hkv)
        if bool((full < skv).any()):
            kw["attn_mask"] = (torch.arange(skv, device=dev)[None, :]
                               < full[:, None])[:, None, None, :]
        elif causal and sq == skv:
            kw["is_causal"] = True
        elif causal:
            raise AssertionError(f"{key}: causal with Sq < Skv needs a mask")
        flops, nbytes = flash_flops_bytes(b, hq, sq, full.tolist(), d, 2,
                                          causal, hkv=hkv)
        out[key] = flash_timed(
            lambda: fk.flash_attention_cuda(
                q, k, v, full, causal=causal, scale=d ** -0.5, seq_dim=1),
            lambda: attention_ref(qt, kt, vt, causal=causal, kv_len=lens),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw),
            flops, nbytes, peak["bf16_flops"], peak)
        out[key].update(route=fk.route(torch.bfloat16, d, sq),
                        library_backend=sdpa_backend(qt, kt, vt, **kw))
        del q, k, v, qt, kt, vt
    return out


def timing_walk(dev, peak):
    """The revocation walk and its plain per-hour loop at the main shape
    (one plain run a turn: it is ~20 launches an hour); the bound is the
    larger of its bytes (us and zs read, three outputs written, avail0 and
    the parameters) and its WALK_OPS float32 operations per lane-hour."""
    from repro_torch.capacity import preemption as pe
    n, p, t = WALK_MAIN
    params, (avail0, us, zs) = walk_inputs(dev, n, p, t, 40)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: pe.revocation_walk(params, avail0, us, zs),
        lambda: pe.revocation_walk_loop(params, avail0, us, zs),
        plain_reps=1)
    nbytes = 4 * (5 * n * p * t + n * p + 3 * p)
    ms_bound, by = bound(WALK_OPS * n * p * t, nbytes, peak["fp32_flops"],
                         peak)
    return dict(shape_n_p_t=[n, p, t], ms=ms, plain_ms=plain_ms,
                kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                bound_ms=ms_bound, bound_by=by, bound_bytes=nbytes,
                bound_ops=WALK_OPS * n * p * t, share_of_bound=ms_bound / ms)


def sweep_work(w, rows, peak):
    """(operations, bytes, (bound ms, by)) of one sweep over ``rows`` rows
    with weights ``w``: per hour with w != 0 a binary search over G + 1
    buckets and its terms, per output a step of the scan; f, w and the
    candidates read once, over and under written once."""
    nnz_w = float((w != 0).sum())
    ops = (nnz_w * (math.ceil(math.log2(MAIN_G + 1)) + OPS_PER_HOUR)
           + OPS_PER_OUTPUT * rows * MAIN_G)
    nbytes = 4 * (2 * rows * MAIN_T + 3 * rows * MAIN_G)
    return ops, nbytes, bound(ops, nbytes, peak["fp32_flops"], peak), nnz_w


def timing_sweep_scenarios(dev, peak):
    """The sweep at the scenario-batched grid plan's shape, SCEN_N x the
    main shape's rows (the plain version in row chunks, fewer turns).
    The wrapper's output there is held against the plain version's (the
    timed pass's) within the tolerance, against the timed launch's and
    against the bucketed plain version (per block of MAIN_P rows, the
    algebra is per row) bit for bit."""
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    from repro_torch.kernels.commitment_sweep import ops as sweep_ops
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_bucketed_ref,
    )
    f, w, cs = main_shape_inputs(dev, pools=NUM_POOLS * SCEN_N)
    rows = f.shape[0]
    last = {}

    def kernel():
        last["kernel"] = ck.commitment_sweep_cuda(f, w, cs)

    def plain():
        last["plain"] = plain_chunked(f, w, cs)

    ms, plain_ms, kern_sets, plain_sets = time_turns(
        kernel, plain, kernel_reps=10, plain_reps=1)
    got = sweep_ops.commitment_sweep_over_under(f, cs, w)
    torch.cuda.synchronize()
    err, rel = compare("scenario_shape", got, last["plain"])
    if not all(torch.equal(a, b) for a, b in zip(got, last["kernel"])):
        raise AssertionError("scenario_shape: the wrapper's sweep != the "
                             "timed launch's bit for bit")
    for i in range(0, rows, MAIN_P):
        want = commitment_sweep_bucketed_ref(
            f[i:i + MAIN_P], w[i:i + MAIN_P], cs[i:i + MAIN_P])
        if not (torch.equal(got[0][i:i + MAIN_P], want[0])
                and torch.equal(got[1][i:i + MAIN_P], want[1])):
            raise AssertionError(
                f"scenario_shape rows {i}..{i + MAIN_P - 1}: kernel != "
                "bucketed plain version bit for bit")
    del last, got, want
    ops, nbytes, (ms_bound, by), _ = sweep_work(w, rows, peak)
    return dict(shape=[rows, MAIN_G, MAIN_T], ms=ms, plain_ms=plain_ms,
                kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                bound_ms=ms_bound, bound_by=by, bound_ops=ops,
                bound_bytes=nbytes, share_of_bound=ms_bound / ms,
                library_ms=None, max_abs_err=err, cost_rel_err=rel,
                equals_bucketed_plain=True)


def phase_timing(dev, launches, errs, turnover):
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    f, w, cs = main_shape_inputs(dev)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: ck.commitment_sweep_cuda(f, w, cs),
        lambda: plain_chunked(f, w, cs))
    ops, nbytes, sweep_bound, nnz_w = sweep_work(w, MAIN_P, peak)
    # reference figures: the brute force's operations over the hours the
    # masks keep, and over every (row, candidate, hour) triple
    masked_flops = FLOPS_PER_TRIPLE * MAIN_G * nnz_w
    full_flops = FLOPS_PER_TRIPLE * MAIN_P * MAIN_G * MAIN_T
    del f, w, cs
    scen = timing_sweep_scenarios(dev, peak)
    fl = timing_flash(dev, peak)
    fl_fam = timing_families_flash(dev, peak)
    lin = timing_linrec(dev, peak)
    mam = timing_mamba(dev, peak)
    walk = timing_walk(dev, peak)
    emit("timing", peak=peak,
         commitment_sweep=dict(
             shape=[MAIN_P, MAIN_G, MAIN_T], kernel_ms=kern_sets,
             plain_ms=plain_sets, bound_ops=ops, bound_bytes=nbytes,
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1],
             share_of_bound=sweep_bound[0] / ms,
             bound_ms_masked_triples=1e3 * masked_flops / peak["fp32_flops"],
             bound_ms_all_triples=1e3 * full_flops / peak["fp32_flops"],
             scenario_shape=scen),
         flash=dict(shapes=dict(
             prefill_tc=f"{FLASH_PREFILL} causal bfloat16",
             simt=f"{FLASH_PREFILL} causal float32",
             simt_d128=f"{FLASH_PREFILL[:3] + (128,)} causal float32",
             prefill_tc_train=f"{(TRAIN_BATCH,) + FLASH_PREFILL[1:]} "
                              "causal bfloat16",
             **{name: f"(B, H, S, Dqk, Dv) = {shape} causal bfloat16"
                for name, shape in (*FLASH_MLA.items(),
                                    *FLASH_MOE_TRAIN.items())},
             prefill_tc_internlm2=f"(B, Hq, Hkv, S, D) = "
                                  f"{FLASH_INTERNLM2_PREFILL} causal "
                                  "bfloat16",
             decode_split=f"{FLASH_DECODE} cache {SERVE_CACHE} bfloat16",
             decode_split_internlm2=f"(slots, Hq, Hkv, D) = "
                                    f"{FLASH_INT8_DECODE} cache "
                                    f"{SERVE_CACHE} bfloat16",
             decode_split_int8=f"(slots, Hq, Hkv, D) = {FLASH_INT8_DECODE} "
                               f"cache {SERVE_CACHE} int8, q bfloat16"),
             **fl, families=fl_fam),
         rwkv6=lin, mamba_scan=mam, revocation_walk=walk,
         generation_turnover=turnover)
    flash_srcs = kernel_modules()["flash_attention"].SOURCES
    flash_mix = launches["flash_by_kernel"]
    pre = fl["prefill_tc"]
    served = launches["serve_families"]
    mbwd = mam["backward"]
    jamba_step = launches["train_families"]["jamba-v0.1-52b"]
    jamba_run = launches["train_families"]["jamba-v0.1-52b run"]
    # each shape's serve phase, whose launches of the shape's route it
    # reports (the phase's total on that kernel)
    shape_phase = {"whisper": "serve_audio", "qwen2vl": "serve_vlm",
                   "jamba": "serve_hybrid"}

    def rel(path):
        return str(path.relative_to(ROOT))
    print(json.dumps({"kernels": [
        {
            "name": "commitment_sweep", "route": "cuda",
            "source": "src/repro_torch/kernels/commitment_sweep/csrc/"
                      "commitment_sweep.cu",
            "replaces":
                "src/repro/kernels/commitment_sweep/commitment_sweep.py:64",
            "launches": launches["commitment_sweep"],
            "launches_per_plan": launches["commitment_sweep"],
            "launches_per_one_shot_plan":
                launches["commitment_sweep_one_shot"],
            # with migration=True, convertible=True the grid plan also
            # sweeps the cloud rows (3 clouds x 8 horizons) every week
            "launches_per_migration_plan":
                launches["commitment_sweep_migration"],
            "migration_cloud_rows_shape": [3 * HORIZON_WEEKS, MAIN_G, MAIN_T],
            # with scenarios=ScenarioConfig(32) the same 234 launches
            # carry 32 x the rows; that shape's times and bound
            "launches_per_scenario_plan":
                launches["commitment_sweep_scenarios"],
            # phase sharded: the same plan over two ranks on the card,
            # 16 futures each, every rank its 234 launches
            "launches_per_sharded_plan_rank":
                launches["commitment_sweep_sharded"],
            # with telemetry=, cadence="breach" or scenarios= under the
            # breach cadence, still one launch per replayed week
            "launches_per_telemetry_breach_plan":
                launches["commitment_sweep_telemetry"],
            # the fleet simulator: simulate_and_plan_pools() (12 x 1 x
            # 1344 and 1 x 1 x 1344), simulate_and_replan_pools(
            # solver="grid") (96 x 128 x 1344 per replayed week, both
            # replays), plan_fleet_portfolio (1 x 1 x 1344)
            "launches_per_fleet_one_shot":
                launches["fleet_sim"]["one_shot"],
            "launches_per_fleet_grid_replan":
                launches["fleet_sim"]["replan_grid"],
            "launches_per_fleet_portfolio":
                launches["fleet_sim"]["plan_fleet"],
            "scenario_shape": {key: scen[key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")},
            "max_abs_err": max(errs["commitment_sweep"],
                               scen["max_abs_err"]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": sweep_bound[0],
            "bound_by": sweep_bound[1], "library_ms": None,
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": rel(flash_srcs["prefill_tc"]),
            "replaces":
                "src/repro/kernels/flash_attention/flash_attention.py:99",
            "launches": launches["flash_attention"],
            "launches_per_serve": launches["flash_attention"],
            # the MoE family's serve runs: granite-moe-1b-a400m (GQA, as
            # serve_dense) and deepseek-v2-lite-16b (MLA: prefill only)
            "launches_per_serve_moe": launches["serve_moe"],
            "launches_per_serve_mla": launches["serve_mla"],
            # the full stablelm-1.6b's train step: each layer's forward
            # and its remat recompute (phase train)
            "launches_per_train_step": launches["train"]["flash_per_step"],
            "launches_per_train_run": launches["train"]["flash_main"],
            # the MoE family's train steps (phase train_moe), prefill_tc
            # at (64, 64) and (192, 128), and those shapes' times
            "launches_per_train_moe_step": launches["train_moe"],
            # the vlm, audio and hybrid families' train steps (phase
            # train_families), prefill_tc causal and non-causal
            "launches_per_train_families_step": {
                arch: launches["train_families"][arch]["prefill_tc"]
                for arch in TRAIN_FAMILIES},
            "moe_train_shapes": {
                name: dict(
                    shape=f"prefill (B, H, S, Dqk, Dv) = {shape} causal bf16",
                    **{key: fl[name][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")})
                for name, shape in FLASH_MOE_TRAIN.items()},
            # the int8 KV cache's serve run (phase serve_int8): every
            # decode_split launch there is the int8 instance; its
            # prefill_tc at the longest prompt
            "launches_per_serve_int8": launches["serve_int8"],
            "serve_int8_prefill_shape": dict(
                shape=f"prefill (B, Hq, Hkv, S, D) = "
                      f"{FLASH_INTERNLM2_PREFILL} causal bf16",
                launches=launches["serve_int8"]["prefill_tc"],
                **{key: fl["prefill_tc_internlm2"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_backend")}),
            "train_shape": dict(
                shape=f"prefill {(TRAIN_BATCH,) + FLASH_PREFILL[1:]} "
                      "causal bf16",
                **{key: fl["prefill_tc_train"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}),
            "max_abs_err": errs["flash_attention"], "ms": pre["ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
            "shape": f"prefill {FLASH_PREFILL} causal bf16",
            "cuda_kernels": {
                kern: dict(
                    source=rel(flash_srcs[kern]),
                    launches=flash_mix[kern], shape=shape,
                    **{key: fl[kern][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "host_ms", "library_host_ms")})
                for kern, shape in (
                    ("prefill_tc", f"prefill {FLASH_PREFILL} causal bf16"),
                    ("decode_split",
                     f"decode {FLASH_DECODE} cache {SERVE_CACHE} bf16"),
                    ("simt", f"prefill {FLASH_PREFILL} causal f32"))} | {
                # decode_split's int8 instance (the same source), beside
                # the bf16 instance at internlm2-20b's shape
                "decode_split_int8": dict(
                    source=rel(flash_srcs["decode_split"]),
                    launches=launches["serve_int8"]["flash_int8"],
                    shape=f"decode (slots, Hq, Hkv, D) = {FLASH_INT8_DECODE}"
                          f" cache {SERVE_CACHE} int8 (bf16 scales), q bf16",
                    **{key: fl["decode_split_int8"][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "host_ms", "library_host_ms",
                        "library_context_ms", "bf16_instance_ms",
                        "bf16_bound_ms")}),
                "decode_split_internlm2": dict(
                    source=rel(flash_srcs["decode_split"]),
                    launches=0,
                    shape=f"decode (slots, Hq, Hkv, D) = {FLASH_INT8_DECODE}"
                          f" cache {SERVE_CACHE} bf16",
                    **{key: fl["decode_split_internlm2"][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "host_ms", "library_host_ms")})},
            # MLA's prefill: (192, 128) on serve_mla's main path (27 x 16
            # launches), (96, 64) minicpm3's (no full-size main path here;
            # model_cpu runs it on simt in float32)
            "mla_shapes": {
                name: dict(
                    shape=f"prefill (B, H, S, Dqk, Dv) = {shape} causal bf16",
                    launches=(launches["serve_mla"]["prefill_tc"]
                              if name == "mla_192_128" else 0),
                    **{key: fl[name][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")})
                for name, shape in FLASH_MLA.items()},
            # the vlm, audio and hybrid serve runs: launches by kernel
            # and decode ticks; the flash kernels at their shapes, each
            # with its route's launches in its serve run
            "launches_per_serve_families": served,
            "family_shapes": {
                key: dict(
                    shape=f"(B, Hq, Hkv, Sq, Skv, D, causal, kv_len) = "
                          f"{case}",
                    route_launches_in_run=served[
                        shape_phase[key.split("_")[0]]][fl_fam[key]["route"]],
                    **{k: fl_fam[key][k] for k in (
                        "route", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")})
                for key, case in FLASH_FAMILIES.items()},
            # the three families' train steps' shapes (phase
            # train_families), each with its run's prefill_tc launches a
            # step (causal and non-causal together)
            "family_train_shapes": {
                key: dict(
                    shape=f"(B, Hq, Hkv, Sq, Skv, D, causal, kv_len) = "
                          f"{case}",
                    route_launches_per_train_step=launches[
                        "train_families"][FLASH_TRAIN_ARCH[
                            key.split("_")[0]]][fl_fam[key]["route"]],
                    **{k: fl_fam[key][k] for k in (
                        "route", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_backend")})
                for key, case in FLASH_FAMILIES_TRAIN.items()},
            # simt at head dim 128, which no main path gives it: a shape
            # timed for ranking, beside the library call
            "simt_d128": dict(
                shape=f"prefill {FLASH_PREFILL[:3] + (128,)} causal f32",
                **{key: fl["simt_d128"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        },
        {
            "name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/linrec/csrc/linrec.cu",
            "replaces": "src/repro/kernels/linrec/linrec.py:92",
            "launches": launches["rwkv6"],
            "launches_per_serve": launches["rwkv6"],
            # rwkv6-3b's train step at 2 layers (phase train): forward and
            # remat recompute per layer
            "launches_per_train_step_2_layers":
                launches["train"]["rwkv6_per_step_2_layers"],
            "launches_per_train_run_2_layers":
                launches["train"]["rwkv6_run"],
            "train_shape": {key: lin["train"][key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by")},
            "max_abs_err": errs["rwkv6"], "ms": lin["main"]["ms"],
            "plain_ms": lin["main"]["plain_ms"],
            "bound_ms": lin["main"]["bound_ms"],
            "bound_by": lin["main"]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the RWKV6 "
                            "recurrence",
            "shape": f"{LINREC_MAIN} float32",
            "cuda_kernels": list(RWKV6_PROFILE_NAMES),
            "short": {key: lin["short"][key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by")},
            "per_serve_run": lin["serve_run"],
        },
        {
            "name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                      "mamba_scan.cu",
            "replaces": "src/repro/models/mamba.py:94",
            "replaces_note": "the jax.lax.associative_scan of _ssm_scan, "
                             "not a Pallas kernel",
            "launches": launches["mamba_scan"],
            "launches_per_serve_hybrid": launches["mamba_scan"],
            # jamba's train step (phase train_families, one period-8
            # block): each Mamba layer's forward and its remat recompute
            "launches_per_train_step_jamba":
                jamba_step["mamba_scan"],
            "launches_per_train_run_jamba": jamba_run["mamba_scan"],
            "max_abs_err": errs["mamba_scan"], "ms": mam["ms"],
            "plain_ms": mam["plain_ms"], "bound_ms": mam["bound_ms"],
            "bound_by": mam["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the selective "
                            "scan",
            "shape": f"(B, S, D, N) = {MAMBA_MAIN} float32",
            "per_serve_run": mam["serve_run"],
            "train_shape": mam["train"],
        },
        {
            "name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                      "mamba_scan.cu",
            "replaces": "src/repro/models/mamba.py:94",
            "replaces_note": "autodiff of the jax.lax.associative_scan of "
                             "_ssm_scan, not a Pallas kernel",
            "launches": jamba_run["mamba_scan_bwd"],
            "launches_per_train_step_jamba": jamba_step["mamba_scan_bwd"],
            "max_abs_err": max(
                errs["mamba_scan_bwd"],
                *(e["max_abs_err"] for k, e in mam["train"]["errors"].items()
                  if k not in ("y", "h"))), "ms": mbwd["ms"],
            "plain_ms": mbwd["plain_ms"], "bound_ms": mbwd["bound_ms"],
            "bound_by": mbwd["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the scan's "
                            "backward",
            "shape": f"(B, S, D, N) = {JAMBA_TRAIN} float32",
        },
        {
            "name": "revocation_walk", "route": "cuda",
            "source": "src/repro_torch/kernels/revocation_walk/csrc/"
                      "revocation_walk.cu",
            "replaces": "src/repro/capacity/preemption.py:190",
            "replaces_note": "the lax.scan over hours of the revocation "
                             "walk, not a Pallas kernel",
            "launches": launches["revocation_walk"],
            "launches_per_spot_replay": launches["revocation_walk"],
            "launches_per_fleet_spot_replay":
                launches["fleet_sim"]["spot_replay"],
            "max_abs_err": errs["revocation_walk"], "ms": walk["ms"],
            "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"],
            "bound_by": walk["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the walk",
            "shape": f"N, P, T = {WALK_MAIN} float32",
        },
        {
            "name": "generation_turnover", "route": "cuda",
            "source": "src/repro_torch/kernels/generation_turnover/csrc/"
                      "generation_turnover.cu",
            "replaces": "src/repro/capacity/generations.py:275",
            "replaces_note": "the lax.scan over hours of migrate_demand "
                             "(its step _mig_step at :251), not a Pallas "
                             "kernel",
            "launches": launches["generation_turnover"],
            "launches_per_turnover_fleet": launches["generation_turnover"],
            "launches_per_fleet_migration_replan":
                launches["fleet_sim"]["replan_migration"],
            "max_abs_err": errs["generation_turnover"],
            "ms": turnover["ms"], "plain_ms": turnover["plain_ms"],
            "bound_ms": turnover["bound_ms"],
            "bound_by": turnover["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the turnover",
            "shape": f"P, T = {tuple(turnover['shape_p_t'])} float32",
        },
    ]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_device()
    phase_build()
    errs = {"commitment_sweep": phase_kernel(dev)}
    phase_ties(dev)
    errs["flash_attention"] = phase_flash(dev)
    errs["rwkv6"] = phase_linrec(dev)
    errs["mamba_scan"], errs["mamba_scan_bwd"] = phase_mamba(dev)
    errs["revocation_walk"] = phase_walk(dev)
    from repro_torch import configs
    from repro_torch.data import traces
    errs["generation_turnover"], turnover = phase_turnover(
        dev, traces.synthetic_base_pool_set(
            num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0))
    t0 = time.perf_counter()
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0)
    emit("fleet", pools=NUM_POOLS, hours=NUM_HOURS,
         synth_s=time.perf_counter() - t0)
    refs = CpuRefs()
    try:
        phase_cpu(pools, refs)
        grid_rep, sweep_launches, plan_s = phase_plan(pools)
        phase_quantile(pools, grid_rep)
        one_shot_launches = phase_one_shot(pools, dev)
        walk_launches, spot_rep = phase_spot(pools, grid_rep, refs)
        turnover_launches, migration_launches, mig_pools, mig_rep = (
            phase_migration(grid_rep, refs))
        plan_profile = phase_profile(pools, grid_rep, plan_s)
        scenario_launches = phase_scenarios(pools, grid_rep, plan_s,
                                            plan_profile, spot_rep,
                                            mig_pools, mig_rep)
        telemetry_launches = phase_telemetry(pools, grid_rep)
        del pools, grid_rep, spot_rep, mig_pools, mig_rep
        fleet_launches = phase_fleet_sim(dev)
        phase_tournament(dev)
        refs.finish()
    finally:
        refs.close()
    sharded_launches = phase_sharded(dev)
    phase_autoscaler(dev)
    phase_model_cpu(dev)
    launches = {"commitment_sweep": sweep_launches,
                "commitment_sweep_one_shot": one_shot_launches,
                "revocation_walk": walk_launches,
                "generation_turnover": turnover_launches,
                "commitment_sweep_migration": migration_launches,
                "commitment_sweep_scenarios": scenario_launches,
                "commitment_sweep_telemetry": telemetry_launches,
                "fleet_sim": fleet_launches,
                "commitment_sweep_sharded": sharded_launches}
    launches["flash_attention"], dense = phase_serve(
        "serve_dense", configs.get("stablelm-1.6b"), dev, "flash_attention")
    launches["flash_by_kernel"] = dense["launches"]["flash_by_kernel"]
    launches["rwkv6"], _ = phase_serve(
        "serve_rwkv", configs.get("rwkv6-3b"), dev, "rwkv6")
    for name, arch in (("serve_moe", "granite-moe-1b-a400m"),
                       ("serve_mla", "deepseek-v2-lite-16b")):
        _, out = phase_serve(name, configs.get(arch), dev, "flash_attention")
        launches[name] = out["launches"]["flash_by_kernel"]
    int8_launches = phase_serve_int8(dev)[1]["launches"]
    launches["serve_int8"] = dict(int8_launches["flash_by_kernel"],
                                  flash_int8=int8_launches["flash_int8"])
    launches["serve_families"] = phase_serve_families(dev)
    launches["mamba_scan"] = launches["serve_families"]["serve_hybrid"][
        "mamba_scan"]
    launches["train"] = phase_train(dev)
    launches["train_moe"] = phase_train_moe(dev)
    launches["train_families"] = phase_train_families(dev)
    launches["train_compressed"] = phase_train_compressed(dev)
    phase_cells(dev)
    phase_timing(dev, launches, errs, turnover)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--sharded-rank":
        sys.exit(sharded_rank(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu-ref":
        sys.exit(cpu_ref(sys.argv[2], sys.argv[3]))
    sys.exit(main())
