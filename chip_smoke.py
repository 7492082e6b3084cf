#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases build,serve --bursts 6
                                     # the serve burst timed six times

Phases, in order; any failure raises and the script exits non-zero.
Every model runs at its full width. serve, serve_ckpt and serve_tp run
every layer of theirs; the phases that PHASE_LAYERS names run fewer
(Gemma-2B 6 of 18, Gemma-7B 8 of 28, Llama-3-8B 8 of 32 in serve_paged
and serve_dcn and 16 of 32 in serve_ring and serve_pp, Mixtral 8 of 32
in serve_moe_ep), as serve_moe and serve_kvq do (MOE_LAYERS,
KVQ_LAYERS), so that the whole script stays well inside its 1,200 s:

1. build    -- compile every CUDA kernel of the port from the sources in
               ``ai_agent_kubectl_tpu_torch/csrc`` (one nvcc per source,
               all started together) and print the build time.
2. kernel   -- hold each kernel against its plain PyTorch version on the
               card, in bf16:
               * ragged attention at Gemma-2B's shapes (H=8, KV=1,
                 head_dim 256, page 16, 8 slots): decode at mixed
                 positions, a 5-wide verify window, prefill spans of 64
                 and 512, a q_len=0 slot, sentinel table entries, an
                 unmapped block full of NaN and NaN past every slot's
                 last live key; decode with the keys split over blocks
                 (last keys on and beside split boundaries, position
                 1023) and the mixed prologue at W=64 (two admissions,
                 six decode rows); at Mixtral's grouping (32 query
                 heads over 8 KV heads of 128): decode, the prologue and
                 prefill spans of 512; serve_spec's verify windows at
                 Gemma-7B's MHA (16 over 16 heads of 256): q_len 3 and 5
                 at mixed positions, 8 slots; and one table row's eager
                 prefill windows at Gemma-2B's (W 64, 128 and 256: the
                 system prompt's preload, a replay after a radix match);
               * flash attention at Gemma-7B's shapes (H=KV=16, head_dim
                 256; S 64 and 512 over a 1024-slot cache, from position
                 0 and from 85, a padded tail running past the cache,
                 rows with no visible key, a two-row strided cache view,
                 serve1's prefix-hit shape S=85 over 128 slots with and
                 without a softcap, S=600 with the keys unsplit) and
                 Llama's GQA (H=32, KV=8, head_dim 128: S=256 from 85,
                 serve_paged's prefill S=128 over 128 slots, S=85 with
                 rows that see no key, S=512 unsplit) and Gemma-2B's
                 (H=8, KV=1, head_dim 256: serve_host (b)'s prefills,
                 S=KVLEN=256 from 0 and from 192, S=KVLEN=512 from
                 192), and group admission's prefills (GROUP_FLASH: kpad
                 rows sharing positions from the system prompt's length,
                 Llama's at B = 8 over S = 64 and 128 with kv_limit 128
                 and 256, once with its last row padding, Gemma-2B's at
                 B = 4); each case's key split is printed and checked;
               * the int4 matmul on Gemma-7B's four projection shapes at
                 T in {1, 8, 9, 16, 64, 65, 85, 512, 600}, formats
                 512/512, 256/256 and 128/256 (the GEMV, the tiled path,
                 with and without the contraction split), and on
                 Mixtral's wq (4096x4096) and wk (4096x1024) at T in {1,
                 8, 64, 512, 4096} and its head (4096x32000, 512/256) at
                 T in {1, 8}, and on Llama-3-8B's w_gate (4096x14336),
                 w_down (14336x4096), wk (4096x1024) and head
                 (4096x128256, 512/256 by pick_format) at T in {1, 8, 64,
                 512};
               * both paged decode entry points (contiguous caches and the
                 pool) at Llama-3-8B's grouping (H=32, KV=8, head_dim 128;
                 pages 64 and 16), Gemma-2B's (8 over 1, 256; page 16,
                 and page 64 over serve_host (b)'s span of 1024) and
                 Gemma-7B's (16 over 16, 256), 8 slots at positions 0,
                 page-1, page, on both sides of the first key-split
                 boundary, mid-cache and the span's last slot (every
                 geometry splits the keys; the plan is printed): the dense
                 cache read through its strided view (NaN from each
                 slot's position on and in the trash row), the pool
                 through tables with a block shared by two slots,
                 sentinel entries and every block past the live spans
                 NaN.
               The two sharded wrappers (the model axis: Q and KV heads
               split together, one kernel launch per shard on two
               shards of the one card) at Llama-3-8B's tp=2 (16 over 4
               heads of 128 a shard) and tp=8 (4 over 1): ragged decode
               and a prefill span of 64 (page 16), paged pool decode
               (page 64); ragged at Gemma-7B's tp=2 (8 over 8 of 256):
               each shard against its plain version, and the assembled
               output against the unsharded kernel on the same pool; each
               geometry's ragged windows include serve_spec_tp's verify
               window (W = 5, k = 4; Gemma-7B tp=2 is 8 over 8 heads of
               256 a shard). The dense ladder's kernels on the (data,
               model) shards of serve_moe_ep (d) (dp=2 x tp=2 of
               Mixtral, one card): the paged decode kernel on each
               shard's 4 slots and 16 over 4 heads of 128 (page 64, the
               shard's own cache through its strided view), and flash on
               each model shard of a prompt's prefill of 128 (KVLEN
               128). Each wrapper's launch counter must grow. Group
               admission's scatter (ops/quant.py::kv_set_slots: a
               shallow source, a padding row at the out-of-range slot,
               bf16 and int8 leaves) must equal its CPU result bit for
               bit. The dense paged decode as it follows a ring prefill
               on serve_ring's sp=2,tp=2 (a Llama-3-8B tp=2 shard, 16
               over 4 heads of 128, page 64, a cache of 8,256 positions,
               8 slots near 3,000 and 6,000 on and beside a key-split
               boundary), held against the plain version and timed with
               its bound and SDPA.
3. serve    -- build the port's server from the environment-style config
               (MODEL_NAME=gemma-2b-it, random bf16 weights from a fixed
               seed, DECODE_BATCH_SIZE=8, the default pool and radix
               settings, RATE_LIMIT=1000/minute: the phase sends more than
               the default 10 a minute), start it on 127.0.0.1 and send 8
               concurrent POST /kubectl-command requests plus 2 repeats
               over HTTP (the repeats' 422s are not cached, so they reach
               the engine). Launch counters are zeroed just before and
               read just after.
3b. serve_pipe -- the decode chunk pipeline on serve's cell (Gemma-2B,
               random bf16 weights from seed 0, 8 slots, chunk 16), four
               engines in turn from the environment-style config, each
               served over HTTP and released before the next: the serve
               burst of 8 and its 2 repeats, and in (a) then 4 requests
               one at a time at the engine, seeded at 0.9 (64 tokens).
               (a) The ragged regime at CHUNK_PIPE_DEPTH=3 (the default)
               and at 1. (b) DEVICE_TERMINATION=false at depth 2 with
               DECODE_ATTN=paged and KV_POOL_PAGE=64, and its reference,
               the legacy pool ladder (RAGGED_ATTENTION=off) with device
               termination at depth 1. Every dispatch and admission runs
               under torch.cuda.set_sync_debug_mode("error"), and the
               events of the chunks in flight are queried as each
               dispatch starts and returns. Gates: no synchronizing call
               between dispatches; host reads equal the entries read;
               (a) the sequential transcripts byte-identical between the
               depths, each burst transcript identical or apart first at
               a near tie, the pipe reaching 3 chunks at depth 3, the
               books balanced, ragged launches at least forward steps x
               layers; then a second window with the card made the
               slower side (each forward also queues a device spin of
               twice a forward's host time, torch.cuda._sleep, and a
               fresh burst decodes 32 tokens each): at depth 3 at least
               one dispatch begins while an earlier chunk still runs on
               the card, at depth 1 none begins or returns over one, and
               the transcripts are equal or apart at a near tie; (b) the host
               scan resolved to the legacy ladder with the JAX warning,
               its greedy transcripts byte-identical to the reference's,
               the paged pool and flash kernels launched in both and
               held against their plain versions on the host scan's own
               last inputs, wasted_decode_steps_total read from /metrics
               (at least 0) and decode_pipe_depth 2 there. Printed, no
               claim: burst tok/s at depths 3 and 1, host ms a dispatch,
               the share of dispatches that overlapped a running chunk,
               fetch ms, beside the card's name and power limit.
4. serve1   -- the single-sequence engine: MODEL_NAME=gemma-7b-it,
               QUANT=int4, DECODE_BATCH_SIZE=1, random int4 weights from
               a fixed seed, PREFILL_BUCKETS=64,128,256,512. Over HTTP:
               short queries that hit the system-prompt prefix, one query
               of about 600 tokens (chunked prefill), two repeats. The
               flash and int4 launch counters are zeroed just before and
               must have grown just after; the served first-token logits
               are held against the same forward on the plain versions.
5. serve_paged -- Llama-3-8B (MODEL_NAME=llama-3-8b-instruct, random
               bf16 weights drawn once from seed 0) through two batched
               engines in turn, each built from the environment-style
               config and served over HTTP, DECODE_BATCH_SIZE=8,
               MAX_SEQ_LEN=1024, PREFILL_BUCKETS=64,128,256,512,
               DECODE_ATTN=auto (paged at page 64 for this GQA model),
               RATE_LIMIT=1000/minute:
               (a) KV_POOL=false, the dense KV ladder; (b) the pool with
               RAGGED_ATTENTION=off. Traffic: the serve phase's burst with
               one query of about 600 tokens, then 2 repeats. Paged
               launches must equal layers x decode steps, flash must run
               on the prefills, repeats must hit their prefix and be
               identical (in (a) a group-admitted request's repeat, which
               admits singly, may leave it first at a near tie), (b)'s
               books must balance, and the served logits
               must agree with the plain versions'. (a)'s burst reaches
               an idle scheduler whole (its pop held until all 8 are
               queued), so its 7 prefix hits, which share suffix bucket
               64 and kv_limit 128, admit as one group of kpad 8 (one
               padding row): one flash forward at B = 8 (a tap keeps the
               call's inputs; kernel against plain on them; the shape
               must be one phase 2 holds), _group_admitted grows by one,
               the books balance. Its reference: the same weights in an
               engine from the same config with ADMIT_SCRATCH_MB=1
               (every kpad capped to 0), serving only the burst, no
               group; each transcript equal to (a)'s or apart first at a
               near tie. Printed: the group's first-token ms against the
               singles'.
6. serve_ckpt -- write a Gemma-2B checkpoint in the HF safetensors layout
               (one shard per layer plus one for the embedding and the
               final norm, bf16 values from seed 0, about 5.0 GB) under
               the temp dir, after checking its free space, and serve it
               from MODEL_PATH with API_AUTH_KEY set and RATE_LIMIT and
               the response cache at their defaults:
               (a) bf16 through the pool engine (DECODE_BATCH_SIZE=8):
               loaded leaves equal to the bytes written (embedding rows,
               wq of the first and last layers, transposed); a burst of 8
               keyed queries (statuses as the service decides, ragged
               launches grow), one /kubectl-command/stream repeat of a
               burst query (the SSE's terminal event, and the engine
               called again: a 422 is not cached), one request with no
               key (401), one more keyed request (the 11th of the minute:
               429 with Retry-After), /metrics (http_requests_total per
               route and status as sent), /openapi.json, and the served
               logits against the plain forward;
               (b) QUANT=int4 through the single-sequence engine: every
               quantized leaf bit-equal to quantize_int4 (and the
               embedding to quantize_embed_int8) of (a)'s loaded leaf,
               the load's peak device memory under the quantized tree
               plus the bf16 embedding plus two layers' bf16 slices, and
               one request served (flash and int4 launches grow).
               Load seconds and GB/s, the peak, and the burst's tok/s
               beside the serve phase's are printed; the checkpoint is
               deleted at the end.
7. serve_qos -- the QoS ring over HTTP on Gemma-2B (the serve phase's
               random bf16 weights, seed 0), TENANT_TIERS=bulk-key:
               background,hi-key:interactive, PREEMPT_WAIT_MS=50,
               TENANT_MAX_QUEUE=4, RATE_LIMIT=1000/minute,
               MAX_NEW_TOKENS=256:
               (a) the default pool + ragged regime, 8 slots: a greedy
               background query over HTTP and a sampled one (temperature
               0.9, a fixed seed, a direct engine call under a
               background QoSContext) run alone; then six background
               queries and those two again fill the slots; once every
               slot holds 32 tokens two interactive requests arrive and
               must preempt, each seated within PREEMPT_WAIT_MS plus two
               of this run's decode chunks; then bulk-key sends until a
               request finds 4 of its own queued (the victims count) and
               gets 429 with Retry-After >= 1. Every resume re-maps its
               chain (at most a page prefilled); every victim's
               transcript equals its uncontended one, or leaves it first
               at a near tie (top-2 gap within the serve phase's logit
               tolerance; position and gap printed); statuses as the
               service decides; qos_preemptions_total in /metrics equals
               stats()["qos"]; /health has its qos section; the pool's
               books balance. A sampled step's kernel launches and time
               are printed.
               (b) KV_POOL=false with DECODE_ATTN=paged, 2 slots, the
               two references and one interactive request: its victim
               resumes through a flash prefill.
               Ragged, flash and paged launches are zeroed before each
               engine's traffic and printed after.
8. serve_moe -- Mixtral-8x7B (MODEL_NAME=mixtral-8x7b-instruct) at full
               width, 8 of its 32 layers (MOE_LAYERS; the engines take
               the cut config): dim 4096, 8 experts of 14,336 with 2
               routed per token, 32 query heads over 8 KV heads of 128,
               vocab 32,000. QUANT=int4: attention and the head packed
               int4, the expert stacks int8, the embedding per-row int8,
               drawn once on the card from seed 0 (random_params_int8,
               one [in, out] slice at a time) after checking the free
               device memory, and freed at the end. MAX_SEQ_LEN=1024,
               PREFILL_BUCKETS=64,128,256,512, RATE_LIMIT=1000/minute.
               (a) The pool engine (8 slots, the ragged regime) over
               HTTP: the serve phase's burst of 8 and its 2 repeats;
               statuses as the service decides, prefix hits on the
               repeats, books balanced, served logits against the plain
               versions (ragged and int4) under the serve phase's rule.
               (b) The single-sequence engine (DECODE_BATCH_SIZE=1): one
               query of about 600 tokens (prefix splice, chunked flash
               prefill, int4 decode); served logits likewise (flash and
               int4). Launch counts are zeroed before each part's traffic
               and read after: ragged and int4 in (a), flash and int4 in
               (b) must have grown. Then the dense mix equals the sparse
               pick (dense_moe on served hidden states of one layer
               against a float32 loop over each token's two routed
               experts) and the peak device memory stays under the tree
               plus both engines' KV plus one MoE layer's transient.
               Printed: the routed-expert histogram, init seconds, burst
               tok/s, decode ms a step, TTFT, launches; with --profile
               the MoE MLP's share of a step.
9. serve_kvq -- the int8 KV cache on Llama-3-8B (MODEL_NAME=
               llama-3-8b-instruct, 8 of its 32 layers (KVQ_LAYERS; the
               engines take the cut config), dim 4096, 32 query heads
               over 8 KV heads of 128, MLP 14,336, vocab 128,256) at full
               width: QUANT=int4 (the untied head 512/256, the embedding
               per-row int8) drawn once on the card from seed 0,
               KV_QUANT=int8, MAX_SEQ_LEN=2048,
               PREFILL_BUCKETS=64,128,256,512, RATE_LIMIT=1000/minute.
               (a) The pool engine (8 slots; RAGGED_ATTENTION and
               DECODE_ATTN at auto), which must resolve to the gather
               regime and log why: the serve phase's burst and its 2
               repeats over HTTP. (b) The dense ladder (KV_POOL=false,
               DECODE_ATTN=paged asked), which must resolve to dense and
               log why: the burst with one query of about 600 tokens and
               the 2 repeats. (c) The single-sequence engine
               (DECODE_BATCH_SIZE=1): one query of about 600 tokens (the
               int8 prefix splice, chunked dense prefill, int4 decode).
               Flash prefill must resolve to dense in all three. Gates:
               statuses as the service decides; the repeats hit their
               prefix and (a)'s books balance; the served logits against
               the plain int4 version over the same int8 cache, by the
               serve phase's rule; launch counters zeroed before each
               part's traffic: the int4 kernel's grows (in (a) by its
               count a forward times the forward steps), the ragged,
               paged and flash counters stay 0; the KV cache's bytes,
               read from its tensors, equal 2 L rows KV (hd + 4) and are
               at most 0.52x a bf16 cache of the same geometry; the peak
               device memory stays under what earlier phases left
               resident, plus the tree, plus the three engines' caches,
               plus a transient the phase states before it runs; the
               W8A8 s32 product on the card equals the CPU's bit for bit
               at Llama's wq and w_gate for T in {1, 8, 17, 64}. Printed:
               burst tok/s, decode ms a step and TTFT per part, and the
               gap between int8-KV and bf16-KV logits on one prompt; with
               --profile, the shares of a decode step that go to the
               gather, the int8 -> float32 convert and
               dense_attention_quant.
10. serve_obs -- the telemetry plane on the card.
               (a) Gemma-2B served as the serve phase serves it (random
               bf16 weights from seed 0, the pool and ragged regime, 8
               slots) with DEBUG_TOKEN set, LOG_FORMAT=json, the ledger
               and the sentinel at their defaults (on),
               SENTINEL_EVAL_SECS=0.5, INCIDENT_PROFILE_SECS=1 and
               PERF_BASELINES naming a file this phase writes under
               build/ with a decode envelope of 0.01 ms a step, which no
               card meets. Traffic: the serve burst and its 2 repeats,
               then 16 fresh queries with POST /debug/profile?seconds=2
               sent while they decode. Gates: every /debug/* route 403s
               without X-Debug-Token; /debug/requests lists every burst
               request id, a detail answers 200 and an unknown id 404;
               /debug/chunks holds as many dispatch and consume events as
               stats() counts; /debug/ledger's books balance and its
               delivered steps equal the tokens the responses returned
               (128 each: random weights never emit EOS); /debug/incidents
               holds one steptime_breach incident whose bundle carries a
               trace directory, the cooldown suppressing the next firing;
               /health has its slo, steptime and incidents sections and
               /metrics the telemetry families; every JSON log line of a
               request carries its request id; the profile's trace,
               attributed (obs/attribution.py), has span_source
               cuda_device, bills every ragged kernel and combine to
               attention and the GEMM libraries' kernels to weight_gemms
               (or lm_head_sampling under the head's scope), and leaves at
               most 10 % of the device's busy time in other_device.
               (b) run_attribution on Gemma-7B with QUANT=int4 (8 slots,
               chunk 8, 4 reps): the artifact validates with span_source
               cuda_device and every int4 kernel span bills weight_gemms.
               Both tables are printed, and the serve phase's burst tok/s
               beside (a)'s first burst.
11. serve_chaos -- blast-radius containment on the card: Gemma-2B as the
               serve phase serves it (random bf16 weights from seed 0, 8
               slots) over HTTP with the default breaker, FAULT_POINTS=
               decode:nan:0 (the factory threads one injector into the
               batcher; each drill re-arms it) and CACHE_TTL=0.001 (every
               drill's request reaches the engine). Each drill sends the
               serve burst, as the fault-free reference does first.
               (a) The pool and ragged regime: a one-shot decode:nan on
               one request in its third chunk (budget 1: replayed); a
               persistent decode:nan (410 after 2 trips); scheduler:die
               once every slot decodes (the supervisor restarts the
               thread, nothing dropped); a persistent decode:poison_step
               (bisection isolates it: step_poison, in the 8 resets the
               JAX engine takes for 8 slots with the target third, as a
               CPU test pins). (b) The dense ladder
               (KV_POOL=false, DECODE_ATTN=paged): the one-shot drill,
               its replays prefilling through flash. (c) On (b)'s server,
               the watchdog's limit lowered to 4 s after the warm
               bursts, chunk:hang with two requests in flight: both 503
               within the limit plus one interval plus 1 s, /health 503
               while hung; after release /health 200 and a fresh burst
               served. Gates: statuses as the service decides (the
               poisoned request's 410 excepted); every other transcript
               equal to the reference or leaving it first at a near tie
               (as serve_qos); the counters of each drill (resets by
               cause, quarantines by reason) and their /metrics families
               and /health's last_reset_cause; the peak device memory
               across the one-shot drill's reset at most 5 % over the
               fault-free burst's peak, and less than half the KV pool
               (or dense cache) above it: no second one resident; launches (ragged in (a), flash
               and paged in (b)) zeroed before and grown after. Printed:
               each drill's ms from the trip to the first replayed
               token, its replayed tokens, the memory peaks, and the
               fault-free and one-shot bursts' tok/s.
12. serve_grammar -- grammar-constrained decoding on Gemma-2B (the serve
               phase's random bf16 weights from seed 0, the pool and
               ragged regime, 8 slots).
               (a) Over HTTP with the BPE asset, GRAMMAR_DECODE=true,
               GRAMMAR_PROFILE=default and one background key in
               TENANT_TIERS: the serve burst, two queries with
               X-Grammar-Profile: readonly, one with X-Allowed-Verbs:
               get,describe and one with the background key (clamped to
               readonly), the same burst again with fresh queries
               (every variant compiled by then), then X-Allowed-Verbs:
               get,frobnicate (400).
               Gates: every transcript in grammar for its resolved
               profile (GrammarRuntime.in_grammar over the engine's ids),
               no readonly, narrowed or background transcript on a verb
               outside its set, unsafe_reason None for all, the
               grammar_* families of /metrics equal to /health's totals,
               masked plus forced tokens equal to the tokens generated,
               the books balanced, ragged launches at least layers x
               forward steps, statuses as the service decides. Printed:
               each burst's tok/s and ms a forward step beside the serve
               phase's (the grammar off), no claim, and one decode
               step's fold at 8 slots x the vocabulary with and without
               the grammar (host ms, device busy ms, kernels).
               (b) At the engine: the same weights and regime with
               tokenizer=ByteTokenizer() (an 8-token forced run from
               START) and its EOS id (Gemma's 107 is the byte 'h' there),
               chunk 4,
               requests one at a time, each greedy and at 0.9: fast-
               forward on (GRAMMAR_FORCED_RUN_MIN=4) against off (10**6),
               GRAMMAR_PROFILE=permissive against the grammar off.
               Gates: transcripts equal or apart first at a near tie (as
               serve_qos, over the legal tokens only); with it on every
               request takes an admission splice of >= 8 tokens, strictly
               fewer masked steps than off, and every mid-stream splice
               launches the ragged kernel once a layer at least.
               Launch counters are zeroed before each engine's traffic.
13. serve_spec -- speculative decoding.
               (a) Over HTTP: MODEL_NAME=gemma-7b-it, QUANT=int4 (random
               weights from seed 0) verifying SPEC_DRAFT_MODEL=gemma-2b-it
               (random bf16 from seed 1, never quantized), SPEC_DRAFT_K=4,
               the pool and ragged regime, 8 slots, serve's
               MAX_NEW_TOKENS: the serve burst and its 2 repeats. Gates: statuses as the
               service decides; /health's spec section enabled, active,
               k=4, drafted > 0; the spec_* families of /metrics equal to
               it; the ledger's draft_rejected equal to drafted minus
               accepted, conservation balanced; the books balanced; ragged
               launches at least layers x verify forwards, int4 launches
               grown. Then the same target weights with spec off, the
               burst's prompts at once: each transcript equal to (a)'s or
               apart first at a near tie (serve_qos's rule).
               (b) At the engine: Gemma-2B (random bf16 from seed 0, the
               BPE asset, 8 slots) with an identical draft
               (spec_draft_seed=0), k = 2 and 4, one burst of four
               prompts greedy and at 0.9, in the ragged and the gather
               regime (RAGGED_ATTENTION=off), against spec off in each;
               then draft:die armed mid-burst and one burst after it.
               Gates: accepted > 0 in the ragged regime; transcripts
               equal or apart first at a near tie; the drill fires once,
               degraded_total 1, no verify forward after the chunk in
               flight, both bursts as spec off; books and ledger
               balanced. Printed, no claim: tok/s spec on and off, the
               acceptance ratio, ms a verify iteration, draft and target
               forwards a chunk.
14. serve_host -- the two-tier host KV (HOST_KV_BLOCKS=512) on Gemma-2B
               (the serve phase's random bf16 weights from seed 0, 8
               slots, MAX_NEW_TOKENS=32) over HTTP, in (a) the ragged
               regime at page 16 and (b) RAGGED_ATTENTION=off with
               DECODE_ATTN=paged at page 64 (the paged pool kernel reads
               the onloaded pages at decode, flash at prefill). Each
               regime's KV_POOL_BLOCKS holds eight slots at the longest
               turn 2 the phase sends but not sixteen sessions' chains
               (printed). Traffic: 16 sessions (X-Session-ID) of two
               turns, all turn 1s at once, then all turn 2s (turn 1's
               query, its answer and a follow-up). Gates: blocks demoted
               and onloaded; turn 2's radix hits cover the full pages of
               turn 1's prompt that turn 2's rendered prompt shares (the
               template ends the query with "\nKubectl Command:"); every
               onloaded block bit-identical on the card to its device
               bytes before the demote; each turn 2 equal to a
               HOST_KV_BLOCKS=0 engine's cold serving of it, or apart
               first at a near tie (serve_qos's rule); statuses as the
               service decides; /health's kv_pool carries host_tier and
               starved_slots_total and /metrics the five host-tier
               families; the books balanced across both tiers; the
               regime's kernels launched. In (b) the paged pool kernel
               and flash are wrapped for the traffic: each shape they
               ran at must be one phase 2 holds, and each is held
               against its plain version on the traffic's own last
               inputs at that shape. In (a) also: onload:corrupt
               over HTTP (no failed request, kv_onload_fail_total{cause=
               "corrupt"} up by 1, the transcript as cold); offload:fail
               (the pool after the eviction as the host-off engine's,
               turn 2 as its); a decode:nan quarantine with host pages
               resident (both tiers rebuilt empty, counters carried,
               books balanced). Then two slots of 160-token budgets in
               a 16-block pool (MAX_SEQ_LEN=256): slots starve, are
               counted in starved_slots_total and fire pool_exhausted
               (C7). Printed, no claim: ms and GB/s per demoted and
               onloaded block beside a 256 MiB pinned copy's GB/s, and
               the TTFT of a turn 2 from host pages against the cold
               re-prefill, each alone.
15. serve_fleet -- the engine fleet and the zero-downtime weight
               rollout: FLEET_SIZE=2 Gemma-2B replicas (the serve
               phase's random bf16 weights from seed 0, 8 slots each,
               the pool and ragged regime) on one card, served over HTTP
               from the environment-style config. (a) 16 concurrent
               queries, then serve's two repeats. Gates: both replicas'
               forward steps grow; statuses as the service decides; each
               transcript replica 0's alone on the same 16 prompts (two
               waves of 8), or apart first at a near tie; /health's fleet section and
               the fleet_* families as the routing went. (b) Eight
               requests of 128 tokens (greedy, and seeded at 0.9) seated
               on replica 0, its scheduler held once each holds 32
               tokens, then drain(0). Gates: all eight finish on replica
               1; each transcript its undisturbed run's (replica 1
               alone) or apart first at a near tie;
               fleet_migrations_total 8 and fleet_migrated_tokens_total
               the sum of the exported prefixes; the ledger balanced;
               rejoin(0), and a fresh request routes to it. (c) With
               ROLLOUT_OBSERVE_SECS=3, ROLLOUT_CANARY_SHARE=0.5 and a
               trickle of requests throughout, three rollouts over
               POST /admin/rollout: onto the seed-1 sentinel with
               r0:checkpoint:corrupt armed at boot (rolled_back,
               checkpoint_corrupt, both replicas and a probe's
               transcript on v1), the same rollout clean (complete, both
               on v2, X-Model-Version and the rollout_* families moved,
               the probe, a radix hit on the preloaded system prompt,
               equal to a fresh engine's on v2's weights, and every
               replica's preloaded system-prompt KV bytes a fresh v2
               engine's, none of v1's), and back onto the seed-0
               sentinel (the probe v1's byte for byte, the preloaded KV
               v1's bit for bit); no trickle request dropped. The SLO
               targets are 60 s in this phase (SLO_TTFT_MS,
               SLO_INTERACTIVE_MS): the drills test the rollout's
               mechanics, not the burn gate's verdict; and
               DRAIN_TIMEOUT_SECS=60, so that a stream left to finish
               in place by a promotion's drain can (a step takes ~100 ms
               while both replicas decode). Launch counts are zeroed as
               each window of the fleet's own traffic opens ((a)'s burst
               and repeats, (b)'s migration and rejoin, (c)'s rollouts
               with the trickle and probes) and read as it closes; each
               window's ragged launches must reach its replicas' forward
               steps times the layers. The runs the fleet is held against
               (replica 0 alone, replica 1 undisturbed, the fresh v2
               engine) count apart, as reference_launches. Every ragged
               shape the traffic launched must be one phase 2 holds, and
               each is held against the plain version on its own last
               inputs.
               Printed, no claim: requests per replica, migrations and
               migrated tokens, ms from drain(0) to the last migrated
               request's first resumed token, a swap's seconds per
               replica, peak device memory across each rollout above its
               start, the probe's TTFT before and after a swap, seconds
               in each rollout state, the burst's tok/s through the
               fleet beside one 8-slot engine's.
15b. serve_tp -- tensor-parallel serving (MESH_SHAPE=tp=2) of
               Llama-3-8B in bf16 at full width and all 32 layers
               (random weights from seed 0), its two shards on one card
               (the engine's devices=[cuda:0] * 2; NCCL across cards is
               a later slice), over HTTP: (a) the ragged regime, (b)
               RAGGED_ATTENTION=off (the paged pool decode), (c) the
               dense KV ladder (KV_POOL=false); eight queries each, 64
               new tokens. Gates: the sharded ragged launches in (a)'s
               window equal tp x layers x forward steps; (b) launches
               the sharded paged kernel and (c) the per-shard paged and
               flash kernels, in multiples of tp x layers; each shard's
               kernel inputs tapped during the traffic and held against
               the plain version; the pool books balanced and every
               shard's K and V its own contiguous [blocks, page, 4, 128]
               tensor; /health's sharding section (devices 2,
               pool_sharded, the regime) and the mesh families of
               /metrics; one forward step's logits against the
               unsharded forward on the same weights (rms of the error
               within LOGIT_RTOL of the logits' rms, max within
               TP_LOGIT_MAX). The unsharded reference engine's greedy
               transcripts are compared and printed, not gated (bf16
               sums in another order flip near ties); its launches
               count apart. Printed: peak device memory, tok/s of each
               burst (two shards on one card measure no interconnect:
               no claim).
15c. serve_spec_tp -- speculative decoding on a tensor-parallel mesh:
               Gemma-7B (QUANT=int4, which serves int8 on the mesh as in
               JAX; random weights from seed 0) verifying Gemma-2B's
               drafts (seed 1) at SPEC_DRAFT_K=4, MESH_SHAPE=tp=2 on two
               shards of the one card, both models cut by PHASE_LAYERS
               (Gemma-7B 8 of 28 layers, Gemma-2B 6 of 18, widths
               untouched) and 32 new tokens, so that the whole script
               stays inside its time budget. Over HTTP: the serve burst
               of 8 queries at once, then one request with draft:die
               armed. Gemma-2B's single KV head does not divide tp=2, so
               its cache serves replicated (the JAX fallback). Gates:
               statuses as the service decides (the drill's request
               too); /health's spec and sharding sections draft_sharded
               and draft_kv_fallback true, /metrics spec_draft_sharded
               and spec_draft_kv_fallback 1; drafts made (acceptance
               printed); the books and the ledger balanced; draft:die
               fired once and degraded once; the sharded ragged launches
               in multiples of tp x layers, each shard's kernel inputs
               tapped during the traffic (a verify window among them)
               and held against the plain version; one forward step's
               logits against the unsharded forward (serve_tp's
               TP_LOGIT_MAX rule); the burst's greedy transcripts equal
               to the unsharded spec-off engine's on the same target
               weights or apart first at a near tie.
15d. serve_moe_ep -- Mixtral-8x7B at full width on expert and data
               meshes of the one card, MOE_LAYERS (8 of 32) layers: a
               32-layer int8-expert copy is ~46 GB, and the shards plus
               the unsharded reference on the same weights would not fit
               the card's 80 GB. Runs, each from the environment-style
               config, against the unsharded dense engine on the same
               weights (random from seed 0): (a) MOE_IMPL=ep on one
               device (the one-device expert mesh; int4 attention
               through the int4 kernel, int8 experts); (b) tp=2, dense
               MoE under tp; (c) ep=2; (d) dp=2,ep=2,tp=2 on eight
               shards, where the pool falls back to the dense ladder
               (the paged decode and flash kernels once per shard);
               (b)-(d) on an int8 tree (QUANT=int4 serves int8 on a
               multi-device mesh). Two queries each, one at a time, 8
               new tokens, the system prompt's radix preload off
               (HBM_PREFIX_CACHE=false: each request prefills its own
               prompt, and no request inherits a preload's drops). The
               prefill's capacity (2 k T_local / E) may
               drop tokens, in JAX too: the phase counts each request's
               dropped picks from the router's own (a tap on the
               dispatch; the package has no counter) and gates the
               transcripts of requests whose prefill dropped nothing
               (equal, or apart first at a near tie), the first prefill
               dispatch of each run against dense_moe over its kept
               tokens (rms within LOGIT_RTOL), the run's kernel launched
               in multiples of shards x layers, the dispatch run where
               an expert axis serves it, kv_pool_mesh_fallback 1 in
               /metrics and true in /health for (d) only, and (d)'s
               per-shard kernel inputs against the plain versions; at
               least one transcript gated in the phase. Decode runs at
               capacity T_local and drops nothing.
               Printed: each run's seconds, tok/s and drops (shards on
               one card measure no interconnect: no claim).
15e. serve_ring -- ring prefill on a seq axis: Llama-3-8B bf16 at full
               width, 16 of its 32 layers (random weights from seed 0)
               on MESH_SHAPE sp=2
               (two shards of the one card) and sp=2,tp=2 (four), with
               MAX_SEQ_LEN=8192, the default buckets (largest 1,024),
               HBM_PREFIX_CACHE=false and DECODE_ATTN=paged (page 64).
               Over HTTP: two pasted event dumps of about 3,000 and
               6,000 tokens (padded to 4,096 and 8,192, prefilled by the
               ring) beside six short queries, 16 new tokens each; then
               the 6,000-token dump through the single-sequence engine
               on sp=2, and the 3,000-token one on sp=3, which 4,096
               does not divide (the chunked fallback). Reference: the
               unsharded dense-ladder engine on the same weights (the
               long prompts prefilled in chunks through flash). Gates:
               the ring ran where it must (counted on each engine) and
               fell back on sp=3; every first-token logits of a long
               prompt against the reference's within serve_tp's rule;
               greedy transcripts equal or apart first at a near tie
               (a top-2 gap within TP_LOGIT_MAX of the logits' rms);
               /health's sharding mesh seq 2 and kv_pool_mesh_fallback
               true, the /metrics gauge 1, the fallback warned; decode
               through row 4 and short prefills through row 3, their
               inputs tapped and held against the plain versions; the
               books balanced. Printed: ring prefill ms against the
               reference's chunked prefill ms, peak memory, row 4's and
               row 3's launches per run.
15f. serve_pp -- pipeline stages on a pipe axis: Llama-3-8B bf16 at full
               width, 16 of its 32 layers (seed 0) on pp=2 (two shards of
               the card), pp=2,tp=2
               and pp=2,tp=2 with KV_QUANT=int8 (four), DECODE_ATTN=paged
               (which a pipe axis turns to dense, loudly), the burst of 8
               queries over HTTP, 16 new tokens. Reference: the unsharded
               dense-ladder engine (dense decode; int8 KV for the int8
               run). Gates: one prefill step's logits within serve_tp's
               rule; greedy transcripts equal or apart first at a near
               tie; each stage's shards hold L/pp layers of the weights
               and of the cache (payload and scales); the pool and paged
               decode fell back, warned; /health's mesh pipe 2 and the
               residual split off; no kernel launched inside a stage (the
               JAX stage body is dense); the books balanced. Printed:
               bytes of weights and KV per stage, the microbatch counts,
               tok/s against the reference (one card carries every
               stage: no claim).
15g. serve_dcn -- two processes over gloo on the one card (DCN and
               distributed init): Llama-3-8B bf16 at full width, 8 of
               its 32 layers, seed 0; each rank a subprocess of this
               script (``--rank-of serve_dcn``) running the port's
               server entry point on two shards of the card
               (``--devices cuda:0,cuda:0``), rank 0 on HTTP. (a) Before
               serving, a forward of 4 rows x 128 columns (flash per
               shard) over tp=2 x DCN dp=2, whose batch crosses the
               process boundary: rank 0's logits torch.equal to the
               one-process dp=2,tp=2 mesh's on [cuda:0] * 4 in the same
               shard order (run twice there: its own determinism), none
               on rank 1 (only rank 0 samples). (b) The pool engine over tp=2 x DCN
               tp=2 (a data axis takes the pool away, the JAX rule),
               four queries each alone and then as a burst through the
               stream route, 16 new tokens: transcripts byte-identical
               to the one-process tp=4 mesh's, and against the
               unsharded engine equal or at a near tie (TP_LOGIT_MAX's
               rule). (c) The books on rank 0 (/health's pool, /metrics).
               (d) Each rank's own launches of row 6 while it served
               (counted from the end of its engine's start, the warm-up
               and (a) apart), above zero on both. (e) Rank 1 binds
               no port; both ranks exit 0 once rank 0 is stopped
               (SIGTERM). (f) The single-sequence
               engine over DCN dp=2 answers one query as its one-process
               mesh does; flash (row 3) launches on both ranks while
               they serve. Printed:
               ms a forward in two processes and in one, each burst
               against the one-process mesh's, ms posting a call, each
               rank's traffic with the other (collectives, seconds,
               bytes), launches per rank while serving and before,
               the phase's seconds.
16. timing  -- time each kernel, its plain version, one PyTorch library
               call computing the same function, and its bound, at the
               shapes the serving paths give it (serve_moe's and
               serve_kvq's int4 projections, serve_moe's ragged decode,
               serve_spec's verify window and its int4 projections at T
               = 40, serve_host (b)'s paged decode and turn-2 prefill on
               Gemma-2B, serve_paged (a)'s group prefill at B = 8 and a
               Gemma-2B group at B = 4 included; one shard's ragged and
               paged pool decode at Llama-3-8B's tp=2; one shard's
               ragged verify window of Gemma-7B tp=2, dense paged decode
               of a (data, model) shard of Mixtral and flash on a model
               shard of its prefill); with --profile,
               also the device time of each kernel a call launches (an
               attention kernel and its split combine).

ENGINE=fake (the rule-table engine, engine/fake.py) runs no model and
touches no device, so it has no phase here; the CPU tests hold it against
the JAX package's fakes.

The line before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; before it, one ``{"kernels": [...]}`` JSON line. The last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
package beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import faulthandler
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "ai_agent_kubectl_tpu_torch"
PHASES = ("build", "kernel", "serve", "serve_pipe", "serve1", "serve_paged",
          "serve_ckpt", "serve_qos", "serve_moe", "serve_kvq", "serve_obs",
          "serve_chaos", "serve_grammar", "serve_spec", "serve_host",
          "serve_fleet", "serve_tp", "serve_spec_tp", "serve_moe_ep",
          "serve_ring", "serve_pp", "serve_dcn", "timing")
#: the environment the script started with; each serving phase starts
#: from it (_phase_env), so no knob of one phase leaks into the next
START_ENV = dict(os.environ)

#: the layers a phase's engines run of each model it serves, where that is
#: fewer than the model's own (widths untouched; phase_layers puts the cut
#: config in the port's registry for the phase, so every engine and
#: reference the phase builds takes it). A serving step's time is the
#: host's launches, so it grows with the layers, and the whole script
#: must finish well inside its 1,200 s on a card shared with a busy host.
#: serve, serve_ckpt and serve_tp run every layer; serve_moe and serve_kvq
#: take MOE_LAYERS and KVQ_LAYERS; serve_ring and serve_pp half of
#: Llama-3-8B's layers since serve_dcn joined them.
PHASE_LAYERS = {
    "serve_pipe": {"gemma-2b-it": 6},
    "serve1": {"gemma-7b-it": 8},
    "serve_paged": {"llama-3-8b-instruct": 8},
    "serve_qos": {"gemma-2b-it": 6},
    "serve_obs": {"gemma-2b-it": 6, "gemma-7b-it": 8},
    "serve_chaos": {"gemma-2b-it": 6},
    "serve_grammar": {"gemma-2b-it": 6},
    "serve_spec": {"gemma-2b-it": 6, "gemma-7b-it": 8},
    "serve_host": {"gemma-2b-it": 6},
    "serve_fleet": {"gemma-2b-it": 6},
    "serve_spec_tp": {"gemma-2b-it": 6, "gemma-7b-it": 8},
    "serve_moe_ep": {"mixtral-8x7b-instruct": 8},     # MOE_LAYERS
    "serve_dcn": {"llama-3-8b-instruct": 8},
    "serve_ring": {"llama-3-8b-instruct": 16},
    "serve_pp": {"llama-3-8b-instruct": 16},
}
#: seconds after which every thread's stack is printed to stderr once, so
#: that a run stopped at the limit shows where it was
STACKS_AT_S = 1100

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s. The bound of a kernel is the larger of its bytes
# over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Gemma-2B attention geometry and the serving pool's page.
N_SLOTS, N_HEADS, N_KV, HEAD_DIM, PAGE = 8, 8, 1, 256, 16
MAX_PAGES = 64                       # 1024 positions per slot

# Gemma-7B: full MHA (16 heads of 256) and its projection shapes
# (IN, OUT); wk/wv share wq's shape and w_up shares w_gate's.
G7_HEADS, G7_HD = 16, 256
G7_PROJ = {"wq": (3072, 4096), "wo": (4096, 3072),
           "w_gate": (3072, 24576), "w_down": (24576, 3072)}

#: draft tokens a verify iteration proposes on the card (the JAX default)
SPEC_K = 4
#: the rows of serve_spec's verify forward: every slot's k + 1 columns
SPEC_VERIFY_ROWS = N_SLOTS * (SPEC_K + 1)
#: the admission widths (prefill buckets) of the ragged prologues that
#: serve_spec (a) sends Gemma-7B: phase 2 checks the ragged kernel at
#: each, and the int4 GEMM at each one's 8 x W rows
G7_PROLOGUE_WIDTHS = (64, 128)

# Kernel vs plain, both bf16 in and out: |kernel - plain| <= ATOL +
# RTOL * |plain|. The two round at different places: the kernel rounds
# the unnormalised probabilities exp(s - m_running) to bf16 before P.V
# (as the TPU kernel does), the plain version the normalised ones, and
# each rounds its output to bf16 (half an ulp is 2^-9 relative).
ATOL, RTOL = 1e-2, 2e-2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# ------------------------------------------------------------ ragged cases

def ragged_case(torch, gen, *, W, positions, q_lens, nan_block=True,
                H=N_HEADS, KV=N_KV, hd=HEAD_DIM, page=PAGE, device="cuda"):
    """One ragged-attention call, at Gemma-2B's shapes unless ``H``,
    ``KV``, ``hd`` and ``page`` say otherwise (Mixtral's 32 over 8 of 128
    at the page of 64 its pool serves with): each slot spans
    MAX_PAGES * PAGE positions, in a pool of one block per slot page
    plus one, tables that map each slot's live pages to
    distinct blocks (slot 1 shares slot 0's first block) and hold the
    sentinel past them. With ``nan_block`` the last block (the one a
    clamped sentinel entry lands on) is NaN, and so is every row past a
    slot's last live key in its last live page, where no other slot
    reads: the kernel must read nothing past a tile's last live key."""
    N = len(positions)
    max_pages = MAX_PAGES * PAGE // page
    n_blocks = N * max_pages + 1
    shape = (n_blocks, page, KV, hd)
    k = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    if nan_block:
        k[n_blocks - 1] = float("nan")
        v[n_blocks - 1] = float("nan")
    q = torch.randn((N, W, H, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    sentinel = n_blocks + 7
    tables = torch.full((N, max_pages), sentinel, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(0)).to(torch.int32)
    used = 0
    for n, (p, ql) in enumerate(zip(positions, q_lens)):
        live = -(-(p + max(ql, 1)) // page)
        assert live <= max_pages, (p, ql)
        tables[n, :live] = perm[used:used + live]
        used += live
    if N > 1:
        tables[1, 0] = tables[0, 0]      # a shared prefix page
    if nan_block:
        owners: dict = {}
        for n, (p, ql) in enumerate(zip(positions, q_lens)):
            for b in tables[n, :-(-(p + max(ql, 1)) // page)].tolist():
                owners.setdefault(b, set()).add(n)
        for n, (p, ql) in enumerate(zip(positions, q_lens)):
            last = p + max(ql, 1) - 1    # the slot's last live key
            blk = int(tables[n, last // page])
            if owners[blk] == {n} and last % page < page - 1:
                k[blk, last % page + 1:] = float("nan")
                v[blk, last % page + 1:] = float("nan")
    return dict(
        q=q, k=k, v=v,
        q_lens=torch.tensor(q_lens, dtype=torch.int32, device=device),
        positions=torch.tensor(positions, dtype=torch.int32, device=device),
        block_tables=tables.to(device))


def ragged_cases(torch, gen):
    """The shapes of phase 2: (label, case)."""
    return [
        ("decode", ragged_case(
            torch, gen, W=1,
            positions=[0, 15, 16, 100, 255, 511, 700, 1000],
            q_lens=[1, 1, 1, 0, 1, 1, 1, 1])),
        ("verify5", ragged_case(
            torch, gen, W=5,
            positions=[11, 30, 64, 127, 300, 0, 900, 1017],
            q_lens=[5, 5, 3, 5, 0, 5, 1, 5])),
        ("prefill64", ragged_case(
            torch, gen, W=64,
            positions=[0, 0, 64, 17, 300, 0, 500, 900],
            q_lens=[64, 40, 64, 1, 64, 0, 33, 64])),
        ("prefill512", ragged_case(
            torch, gen, W=512,
            positions=[0, 100, 0, 256, 0, 0, 500, 0],
            q_lens=[512, 512, 300, 512, 0, 1, 512, 200])),
        # Decode with the keys split over blocks (64 keys a split at this
        # shape): last keys just before, on and just past split
        # boundaries, a frozen slot and the last position of the table.
        ("decode_split", ragged_case(
            torch, gen, W=1,
            positions=[63, 64, 127, 128, 0, 1023, 500, 191],
            q_lens=[1, 1, 1, 1, 1, 1, 0, 1])),
        # The ragged prologue as _run_chunk dispatches it: two slots
        # admit their prompt's suffix (each prompt 85 tokens) while six
        # decode at q_len 1, in one W=64 window (keys split, 256 a split).
        ("prologue64", ragged_case(torch, gen, **PROLOGUE64)),
        # serve_moe's pool at Mixtral's grouping (32 query heads over 8
        # KV heads of 128): decode, the mixed prologue and 8 prefills.
        ("mixtral_decode", ragged_case(
            torch, gen, W=1, positions=[0, 15, 16, 100, 255, 511, 700, 1000],
            q_lens=[1, 1, 1, 0, 1, 1, 1, 1], **MIXTRAL)),
        ("mixtral_prologue64", ragged_case(torch, gen, **PROLOGUE64,
                                           **MIXTRAL)),
        ("mixtral_prefill512", ragged_case(
            torch, gen, W=512, positions=[0, 100, 0, 256, 0, 0, 500, 0],
            q_lens=[512, 512, 300, 512, 0, 1, 512, 200], **MIXTRAL)),
        # serve_spec's verify windows at Gemma-7B's MHA (16 heads of 256
        # over 16 KV heads: one query row per KV head and column, so a
        # 64-row tile holds k + 1 live rows): k = 2 and k = 4, mixed
        # positions, a frozen slot and one whose window ends early.
        ("g7_verify3", ragged_case(
            torch, gen, W=3, positions=[0, 15, 16, 100, 255, 511, 700, 1000],
            q_lens=[3, 3, 3, 0, 3, 1, 3, 3], **G7)),
        ("g7_verify5", ragged_case(
            torch, gen, W=5, positions=[11, 30, 64, 127, 300, 0, 900, 1017],
            q_lens=[5, 5, 3, 5, 0, 5, 1, 5], **G7)),
        # serve_spec (a)'s admission prologues at Gemma-7B's MHA, one per
        # width of G7_PROLOGUE_WIDTHS: admissions of a whole window, a
        # prompt's suffix and a short one beside decode steps at q_len 1
        # and a frozen slot (64: keys split; 128: two row tiles a head,
        # keys whole).
        ("g7_prologue64", ragged_case(torch, gen, **PROLOGUE64, **G7)),
        ("g7_prologue128", ragged_case(
            torch, gen, W=128, positions=[0, 0, 45, 21, 300, 0, 700, 896],
            q_lens=[85, 128, 40, 64, 1, 0, 1, 128], **G7)),
        # One table row's eager prefill windows (_pool_prefill_span): the
        # system prompt's preload at each start, and a replay after a
        # radix match (a migrated request re-spliced on its new
        # replica, serve_fleet); the keys split at every width here.
        ("prefill1_64", ragged_case(torch, gen, W=64, positions=[0],
                                    q_lens=[59])),
        ("prefill1_64_tail", ragged_case(torch, gen, W=64, positions=[160],
                                         q_lens=[9])),
        ("prefill1_128", ragged_case(torch, gen, W=128, positions=[48],
                                     q_lens=[100])),
        ("prefill1_256", ragged_case(torch, gen, W=256, positions=[64],
                                     q_lens=[200])),
    ]


# The mixed ragged prologue of phases 2 and 6 (see ragged_cases).
PROLOGUE64 = dict(W=64, positions=[21, 45, 100, 150, 200, 260, 512, 1000],
                  q_lens=[64, 40, 1, 1, 1, 1, 1, 1])
# Ragged cases whose key split phase 2 checks (their shapes must split).
RAGGED_SPLIT_CASES = ("decode", "verify5", "prefill64", "decode_split",
                      "prologue64", "mixtral_decode", "g7_verify3",
                      "g7_verify5", "g7_prologue64", "prefill1_64",
                      "prefill1_64_tail", "prefill1_128", "prefill1_256")


def ragged_live_work(case) -> tuple:
    """(bytes, flops) the call needs for THIS data: the live q columns
    (q_len per slot) read once, all of out written once (its padded
    columns are zeros the call must write), the live K/V rows (pos +
    q_len per slot) read once, the index vectors; 4 * hd * H FLOPs per
    attended (query column, key)."""
    q = case["q"]
    N, W, H, hd = q.shape
    KV = case["k"].shape[2]
    pos = case["positions"].tolist()
    ql = case["q_lens"].tolist()
    kv_rows = sum(p + l for p, l in zip(pos, ql) if l > 0)
    pairs = sum(sum(p + j + 1 for j in range(l)) for p, l in zip(pos, ql))
    nbytes = (sum(ql) * H * hd * q.element_size()      # live q in
              + q.numel() * q.element_size()            # out
              + 2 * kv_rows * KV * hd * 2               # live K and V
              + 4 * (2 * N + case["block_tables"].numel()))
    flops = 4 * pairs * H * hd
    return nbytes, flops


def sdpa_inputs(torch, case):
    """The library yardstick's inputs: each slot's live pages gathered
    into a contiguous [N, KV, S, hd] view and the causal-in-window mask.
    Built once; only the library call itself is timed."""
    q, k, v = case["q"], case["k"], case["v"]
    N, W, H, hd = q.shape
    n_blocks, page, KV, _ = k.shape
    pos = case["positions"].long()
    ql = case["q_lens"].long()
    S = int(((pos + ql.clamp(min=1)).max().item() + page - 1) // page * page)
    idx = case["block_tables"][:, :S // page].long().clamp(0, n_blocks - 1)
    kc = k[idx].reshape(N, S, KV, hd).transpose(1, 2).contiguous()
    vc = v[idx].reshape(N, S, KV, hd).transpose(1, 2).contiguous()
    cols = torch.arange(W, device=q.device)
    kv = torch.arange(S, device=q.device)
    mask = ((kv[None, None, :] <= (pos[:, None] + cols[None, :])[:, :, None])
            & (cols[None, :] < ql[:, None])[:, :, None])[:, None]
    return q.transpose(1, 2).contiguous(), kc, vc, mask


# ------------------------------------------------------- flash attention

def flash_case(torch, gen, *, S, KVLEN, offset=0, B=1, H=G7_HEADS,
               KV=G7_HEADS, hd=G7_HD, cache_len=None, shift=7,
               device="cuda"):
    """One flash call: q [B, S, H, hd] at positions offset.. (per row b,
    offset + shift * b), k/v the first KVLEN slots of a [B, cache_len,
    KV, hd] cache (a strided view when cache_len > KVLEN and B > 1)."""
    cache_len = cache_len or KVLEN
    q = torch.randn((B, S, H, hd), generator=gen, device=device).to(
        torch.bfloat16)
    k = torch.randn((B, cache_len, KV, hd), generator=gen,
                    device=device).to(torch.bfloat16)[:, :KVLEN]
    v = torch.randn((B, cache_len, KV, hd), generator=gen,
                    device=device).to(torch.bfloat16)[:, :KVLEN]
    rows = torch.arange(S, dtype=torch.int32, device=device)[None]
    shift = shift * torch.arange(B, dtype=torch.int32,
                                 device=device)[:, None]
    return dict(q=q, k=k, v=v,
                positions=(offset + shift + rows).contiguous())


def group_prefix_tokens() -> int:
    """The system prompt's length in the BPE asset's tokens: where a
    group admission's suffixes start (serve_paged (a)'s Llama-3-8B and a
    Gemma-2B served with the asset share the tokenizer)."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import SYSTEM_PROMPT
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import load_tokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    tok = load_tokenizer(get_config(SERVE_PAGED_ENV["MODEL_NAME"]),
                         SERVE_PAGED_ENV["TOKENIZER_PATH"])
    return len(tok.encode(SYSTEM_PROMPT))


def group_flash_case(torch, gen, *, geometry, B, S, KVLEN, live,
                     device="cuda"):
    """A group admission's prefill, as the engine calls flash: ``B`` =
    kpad rows sharing their positions (the prefix length onwards), the
    first ``live`` of them requests and the rest padding rows, whose
    query and suffix keys repeat one vector each (their tokens are all
    the pad id)."""
    P = group_prefix_tokens()
    case = flash_case(torch, gen, S=S, KVLEN=KVLEN, offset=P, B=B,
                      shift=0, device=device, **geometry)
    if live < B:
        q, k, v = case["q"], case["k"], case["v"]
        q[live:] = q[live:, :1]
        for kv in (k, v):
            kv[live:, P:] = kv[live:, P:P + 1]
    return case


# Gemma-7B's attention geometry at serve_spec's pool page: 16 query heads
# over 16 KV heads of 256.
G7 = dict(H=G7_HEADS, KV=G7_HEADS, hd=G7_HD)
# Llama-3-8B's attention geometry: 32 query heads over 8 KV heads of 128.
LLAMA_HEADS, LLAMA_KV, LLAMA_HD = 32, 8, 128
LLAMA = dict(H=LLAMA_HEADS, KV=LLAMA_KV, hd=LLAMA_HD)
# Mixtral-8x7B's attention has Llama-3-8B's grouping: the flash cases at
# LLAMA cover serve_moe's prefills. Its pool serves pages of 64 (the
# engine raises KV_POOL_PAGE to 64 for a GQA model on the card).
MIXTRAL = dict(LLAMA, page=64)
# Mixtral-8x7B's int4 projections (IN, OUT) at pick_format's format:
# wq and wo 4096x4096, wk and wv 4096x1024, the untied head 4096x32000.
MIXTRAL_PROJ = {"wq": ((4096, 4096), (512, 512)),
                "wk": ((4096, 1024), (512, 512)),
                "lm_head": ((4096, 32000), (512, 256))}
# Rows a Mixtral projection serves: single-sequence decode, the pool's
# 8 decode rows, a prefill window, the pool's widest ragged prologue
# (8 slots x 512).
MIXTRAL_TS = (1, 8, 64, 512, 4096)
# Llama-3-8B's int4 projections (IN, OUT) that no other model here has,
# each at pick_format's format (512/512; the untied head 512/256): the
# MLP's gate (and up) and down, wk and wv, the head. serve_kvq serves
# them (its wq and wo are Mixtral's 4096x4096).
LLAMA_PROJ = {"w_gate": (4096, 14336), "w_down": (14336, 4096),
              "wk": (4096, 1024), "lm_head": (4096, 128256)}
# Rows a Llama projection serves: single-sequence decode, the 8 decode
# rows, a 64-token prefill bucket, a 512-token window.
LLAMA_TS = (1, 8, 64, 512)


def flash_cases(torch, gen):
    """The shapes of phase 2 for flash attention: (label, case)."""
    cases = [
        ("g7_s64_pos0", flash_case(torch, gen, S=64, KVLEN=1024)),
        ("g7_s64_off85", flash_case(torch, gen, S=64, KVLEN=1024,
                                    offset=85)),
        ("g7_s512_pos0", flash_case(torch, gen, S=512, KVLEN=1024)),
        ("g7_s512_off85", flash_case(torch, gen, S=512, KVLEN=1024,
                                     offset=85)),
        # A bucket's padded tail: positions run past the 512-slot span.
        ("g7_s512_tail", flash_case(torch, gen, S=512, KVLEN=512,
                                    offset=85)),
        # Two rows of a 1025-slot cache read through a [:, :640] view.
        ("g7_b2_view", flash_case(torch, gen, S=64, KVLEN=640, offset=85,
                                  B=2, cache_len=1025)),
        # serve1's prefix-hit shape: 85 rows end mid-tile, keys split in 2.
        ("g7_s85_kv128", flash_case(torch, gen, S=85, KVLEN=128)),
        # 160 row tiles: the keys stay whole; the last tile ends mid-tile.
        ("g7_s600_unsplit", flash_case(torch, gen, S=600, KVLEN=1024)),
        ("llama_gqa", flash_case(torch, gen, S=256, KVLEN=1024, offset=85,
                                 **LLAMA)),
        # serve_paged's prefill window (G = 4; keys split in 2).
        ("llama_s128_kv128", flash_case(torch, gen, S=128, KVLEN=128,
                                        **LLAMA)),
        ("llama_s512_unsplit", flash_case(torch, gen, S=512, KVLEN=512,
                                          **LLAMA)),
        # serve_host (b)'s prefills on Gemma-2B (G = 8, hd 256).
        *[(label, flash_case(torch, gen, S=S, KVLEN=KVLEN, offset=offset,
                             **G2B))
          for label, S, KVLEN, offset in G2B_FLASH],
    ]
    # Rows with no visible key: the first three sit before slot 0.
    none = flash_case(torch, gen, S=64, KVLEN=128)
    none["positions"] = none["positions"] - 3
    cases.append(("g7_no_key_rows", none))
    none = flash_case(torch, gen, S=85, KVLEN=128, **LLAMA)
    none["positions"] = none["positions"] - 3
    cases.append(("llama_s85_no_key_rows", none))
    # The optional softcap (before the mask), on the split path.
    capped = flash_case(torch, gen, S=85, KVLEN=128)
    capped["q"] = capped["q"] * 4
    cases.append(("g7_s85_softcap30", dict(capped, logit_softcap=30.0)))
    cases += [(label, group_flash_case(torch, gen, geometry=geom, B=B, S=S,
                                       KVLEN=KVLEN, live=live))
              for label, geom, B, S, KVLEN, live in GROUP_FLASH]
    return cases


# Gemma-2B's attention geometry: 8 query heads over 1 KV head of 256.
G2B = dict(H=N_HEADS, KV=N_KV, hd=HEAD_DIM)
# serve_host (b)'s and serve_pipe (b)'s gather-path prefills on Gemma-2B,
# (label, S, KVLEN, offset): a window is the largest prefill bucket within
# the prompt's KV rung, so a turn 1 (up to 256 tokens) runs S = KVLEN =
# 256 from 0, and a turn 2 after its radix hit of three 64-row pages runs
# from 192 at the rung of 256 or of 512 (positions past KVLEN: the
# bucket's padded tail); serve's 82-88-token queries run S = KVLEN = 128,
# from 64 after a one-page radix hit.
G2B_FLASH = (("g2b_s128_off64", 128, 128, 64),
             ("g2b_s256_pos0", 256, 256, 0),
             ("g2b_s256_off192", 256, 256, 192),
             ("g2b_s512_off192", 512, 512, 192))
# Group admission's prefills (serve_paged (a), the dense KV ladder):
# (label, geometry, kpad, S = suffix bucket, KVLEN = kv_limit, live rows),
# from the prefix length on. serve_paged (a)'s burst sends 7 prefix hits
# at suffix bucket 64 (kv_limit 128) to one group of kpad 8, its last row
# padding; a longer suffix takes bucket 128 (kv_limit 256); Gemma-2B's
# geometry at kpad 4 is the group of a four-slot engine.
GROUP_FLASH = (("llama_group_b8_s64", LLAMA, 8, 64, 128, 8),
               ("llama_group_b8_s64_pad", LLAMA, 8, 64, 128, 7),
               ("llama_group_b8_s128", LLAMA, 8, 128, 256, 8),
               ("g2b_group_b4_s64", G2B, 4, 64, 128, 4))
# Flash cases whose keys must stay whole (every other case splits them):
# Llama's groups fill 256 or more blocks without a split.
FLASH_UNSPLIT_CASES = ("g7_s600_unsplit", "llama_s512_unsplit",
                       "llama_group_b8_s64", "llama_group_b8_s64_pad",
                       "llama_group_b8_s128")


def flash_live_work(case) -> tuple:
    """(bytes, flops) the call needs for THIS data: q read and out
    written once, the K/V rows some query sees (up to the largest
    position, clamped to KVLEN) read once, the positions; 4 * hd FLOPs per
    (query head, visible key)."""
    q, k = case["q"], case["k"]
    B, S, H, hd = q.shape
    KVLEN, KV = k.shape[1], k.shape[2]
    pos = case["positions"].long()
    seen = (pos.clamp(min=-1) + 1).clamp(max=KVLEN)          # [B, S]
    kv_rows = int(seen.amax(dim=1).sum())
    nbytes = (2 * q.numel() * 2 + 2 * kv_rows * KV * hd * 2
              + 4 * pos.numel())
    flops = 4 * hd * H * int(seen.sum())
    return nbytes, flops


def flash_sdpa_inputs(torch, case):
    """The library yardstick's inputs: [B, H, S, hd] copies of q and the
    visible K/V span and the position mask, built once."""
    q, k, v, pos = case["q"], case["k"], case["v"], case["positions"]
    KVLEN = k.shape[1]
    kv = torch.arange(KVLEN, device=q.device)
    mask = (kv[None, None, :] <= pos.long()[:, :, None])[:, None]
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask)


# ------------------------------------------------------------ int4 matmul

# Phase 2's int4 rows: both sides of the GEMV/tiled switch at 8, one and
# two token tiles of 64 (with and without the contraction split, which
# the tiled path takes at wq, wo and w_down up to T=128), serve1's
# prefill buckets, a chunk past 512, and serve_spec's rows: its verify
# forward (8 x (k + 1)) and its ragged prologues (8 x W).
INT4_TS = tuple(sorted({1, 8, 9, 16, 64, 65, 85, 512, 600, SPEC_VERIFY_ROWS,
                        *(N_SLOTS * w for w in G7_PROLOGUE_WIDTHS)}))
INT4_FORMATS = ((512, 512), (256, 256), (128, 256))


def int4_case(torch, gen, *, T, IN, OUT, fmt, device="cuda"):
    """x [T, IN] bf16 and a packed int4 weight of random bytes (every
    nibble value, -8 included) with positive group scales near the
    init's magnitude."""
    from ai_agent_kubectl_tpu_torch.ops.quant4 import QuantInt4

    gi, bo = fmt
    q = torch.randint(-128, 128, (IN, OUT // 2), generator=gen,
                      device=device, dtype=torch.int8)
    scale = (torch.rand((IN // gi, OUT), generator=gen, device=device)
             + 0.5) * (IN ** -0.5 / 7.0)
    x = torch.randn((T, IN), generator=gen, device=device).to(
        torch.bfloat16)
    return x, QuantInt4(q=q, scale=scale, group_in=gi, block_out=bo)


def int4_cases(torch, gen):
    """The shapes of phase 2 for the int4 matmul: (label, x, w)."""
    from ai_agent_kubectl_tpu_torch.ops.quant4 import pick_format

    out = []
    for fmt in INT4_FORMATS:
        for name, (IN, OUT) in G7_PROJ.items():
            for T in INT4_TS:
                x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT, fmt=fmt)
                out.append((f"{name}_T{T}_{fmt[0]}/{fmt[1]}", x, w))
    for name, ((IN, OUT), fmt) in MIXTRAL_PROJ.items():
        for T in MIXTRAL_TS:
            if name == "lm_head" and T > 8:
                continue             # the head reads one column a row
            x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT, fmt=fmt)
            out.append((f"mixtral_{name}_T{T}_{fmt[0]}/{fmt[1]}", x, w))
    for name, (IN, OUT) in LLAMA_PROJ.items():
        fmt = pick_format(IN, OUT)
        for T in LLAMA_TS:
            x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT, fmt=fmt)
            out.append((f"llama_{name}_T{T}_{fmt[0]}/{fmt[1]}", x, w))
    return out


def int4_work(x, w) -> tuple:
    """(bytes, flops): the packed bytes, the scales, x read and y written
    once; 2 * T * IN * OUT FLOPs."""
    T, IN = x.shape
    OUT = w.q.shape[1] * 2
    nbytes = (w.q.numel() + 4 * w.scale.numel() + 2 * T * IN + 2 * T * OUT)
    return nbytes, 2 * T * IN * OUT


# ---------------------------------------------------------- paged decode

def paged_case(torch, gen, *, H, KV, hd, page, positions, span=None,
               device="cuda"):
    """Both entry points' inputs for one geometry, 8 slots at
    ``positions``: the dense cache [N, S, KV, hd] as the model holds it
    (S = ``span``, by default 1024 + 16 page-rounded; one trash row past
    S, read through the
    strided [:, :S] view) with NaN from each slot's position + 1 on, and
    a pool of N * S / page + 1 blocks whose live pages map through
    permuted tables (slot 1 shares slot 0's first block), the rest of the
    table the sentinel, and every block outside the live spans NaN (the
    clamped sentinel lands on one)."""
    N = len(positions)
    S = span or paged_span(page)
    q = torch.randn((N, H, hd), generator=gen, device=device).to(
        torch.bfloat16)
    cache = torch.randn((2, N, S + 1, KV, hd), generator=gen,
                        device=device).to(torch.bfloat16)
    for n, p in enumerate(positions):
        cache[:, n, p + 1:] = float("nan")
    max_pages = S // page
    n_blocks = N * max_pages + 1
    pool = torch.full((2, n_blocks, page, KV, hd), float("nan"),
                      dtype=torch.bfloat16, device=device)
    sentinel = n_blocks + 5
    tables = torch.full((N, max_pages), sentinel, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(0)).to(torch.int32)
    used = 0
    for n, p in enumerate(positions):
        live = p // page + 1
        tables[n, :live] = perm[used:used + live]
        used += live
    tables[1, 0] = tables[0, 0]          # a block shared by two slots
    for n, p in enumerate(positions):
        for j in range(p // page + 1):
            rows = min(page, p + 1 - j * page)
            pool[:, int(tables[n, j]), :rows] = torch.randn(
                (2, rows, KV, hd), generator=gen, device=device).to(
                    torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    return dict(
        dense=dict(q=q, k=cache[0][:, :S], v=cache[1][:, :S], positions=pos,
                   page_size=page),
        pool=dict(q=q, k=pool[0], v=pool[1], positions=pos,
                  block_tables=tables.to(device), page_size=page))


# The span of serve_host (b)'s pool tables: MAX_SEQ_LEN 1024 in whole
# pages of 64.
G2B_POOL_SPAN = 1024
# Phase 2's paged geometries, (label, (H, KV, hd), page, span): Gemma-2B
# at 64 is serve_host (b)'s pool (DECODE_ATTN=paged raises its page to
# 64).
PAGED_GEOMETRIES = (
    ("llama_p64", (LLAMA_HEADS, LLAMA_KV, LLAMA_HD), 64, None),
    ("llama_p16", (LLAMA_HEADS, LLAMA_KV, LLAMA_HD), 16, None),
    ("gemma2b_p16", (N_HEADS, N_KV, HEAD_DIM), 16, None),
    ("gemma2b_p64", (N_HEADS, N_KV, HEAD_DIM), 64, G2B_POOL_SPAN),
    ("gemma7b_p16", (G7_HEADS, G7_HEADS, G7_HD), 16, None))


def paged_span(page: int) -> int:
    """Phase 2's default paged span, the dense cache's: MAX_SEQ_LEN 1024
    plus one 16-token chunk, page-rounded."""
    return -(-(1024 + 16) // page) * page


def paged_cases(torch, gen):
    """The geometries of phase 2 for paged decode: (label, case, plan).
    Every geometry splits the keys over blocks (8 slots give 8 to 128
    blocks); the positions sit at 0, page - 1, page, on both sides of the
    first split boundary (keys_per_split - 1 and keys_per_split), in the
    middle, and on the span's last slot. Both layouts share the span, so
    one plan holds for both."""
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import split_plan

    out = []
    for label, (H, KV, hd), page, span in PAGED_GEOMETRIES:
        S = span or paged_span(page)
        plan = split_plan(N_SLOTS, H, KV, S)
        kps = plan[1]
        positions = [0, page - 1, page, kps - 1, S - 1, kps, 700, 1000]
        out.append((label, paged_case(torch, gen, H=H, KV=KV, hd=hd,
                                      page=page, positions=positions,
                                      span=S),
                    plan))
    return out


def paged_live_work(case, pool: bool) -> tuple:
    """(bytes, flops): q read and out written once, each slot's visible
    K and V rows read once (keys 0..pos, pos + 1 rows of every KV head:
    the rows the function needs, not the pages that hold them),
    positions and, for the pool, the table entries of the live pages;
    4 * hd FLOPs per (query head, visible key)."""
    q, k, page = case["q"], case["k"], case["page_size"]
    N, H, hd = q.shape
    KV = k.shape[2]
    pos = case["positions"].tolist()
    rows = sum(p + 1 for p in pos)
    pages = sum(p // page + 1 for p in pos)
    nbytes = (2 * q.numel() * 2 + 2 * rows * KV * hd * 2
              + 4 * N + (4 * pages if pool else 0))
    flops = 4 * hd * H * rows
    return nbytes, flops


def paged_sdpa_inputs(torch, case, pool: bool):
    """The library yardstick's inputs: each slot's live span gathered
    into a contiguous [N, KV, S_live, hd] view and the key mask (kv <=
    position), built once."""
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import _pool_gather

    q, k, v, pos, page = (case["q"], case["k"], case["v"],
                          case["positions"], case["page_size"])
    S = (int(pos.max()) // page + 1) * page
    if pool:
        k = _pool_gather(k, case["block_tables"], S // page)
        v = _pool_gather(v, case["block_tables"], S // page)
    kc = k[:, :S].transpose(1, 2).contiguous()
    vc = v[:, :S].transpose(1, 2).contiguous()
    live = torch.arange(S, device=q.device)[None, :] <= pos.long()[:, None]
    kc = torch.where(live[:, None, :, None], kc, 0.0)
    vc = torch.where(live[:, None, :, None], vc, 0.0)
    return q[:, :, None], kc, vc, live[:, None, None, :]


def check_close(torch, label, out, ref) -> float:
    """Kernel vs plain within ATOL + RTOL*|plain|, both finite. Returns the
    max abs error."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    if not torch.isfinite(ref).all():
        raise AssertionError(f"{label}: non-finite plain output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    bad = diff > ATOL + RTOL * ref.float().abs()
    if bad.any():
        raise AssertionError(
            f"{label}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} of {out.numel()} values (max abs err "
            f"{err:.3e}; tolerance {ATOL} + {RTOL}*|plain|)")
    return err


# ------------------------------------------------------------------ timing

def time_cuda(torch, fn, *, iters: int, warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn``, from CUDA events around
    each call alone. A 64 MB buffer is read between calls, so every call
    finds the 50 MB L2 cold, as the serving path does (each layer's pool
    slice was last touched a whole forward ago). A read leaves no dirty
    lines behind: a rewrite would leave the timed call to write 50 MB
    back, and charge calls that evict more of the L2 more.

    A device-side spin before each start event keeps the card busy while
    the host runs ``fn`` (the wrapper up to its launches), so that host
    time stays out of the reading. The spin is sized from the warm-up
    calls' host time (four times their median, at least 0.3 ms), and
    every call is checked: its host time, from the spin's launch to
    ``fn``'s return, must be shorter than the spin's own device time
    (events around it), or the card may have idled between the start
    event and the first kernel. Such a call is left out of the mean and
    counted as ``uncovered``. While fewer than half of ``iters`` calls
    are covered, another ``iters`` are taken (a host-heavy plain version
    leaves about half uncovered), up to four rounds; the timing fails if
    they still fall short. Returns ``{"ms", "host_ms_max", "spin_ms_min",
    "uncovered", "calls"}``."""
    def event():
        return torch.cuda.Event(enable_timing=True)

    scratch = torch.zeros(16 << 20, dtype=torch.int32, device="cuda")
    host = []
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    a, b = event(), event()
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 1_000_000 / a.elapsed_time(b)
    spin_ms = max(0.3, 4e3 * sorted(host)[len(host) // 2])
    cycles = int(spin_ms * cycles_per_ms)
    host, spins, covered = [], [], []
    while 2 * len(covered) < iters and len(host) < 4 * iters:
        pres, starts, ends = ([event() for _ in range(iters)]
                              for _ in range(3))
        took = []
        for i in range(iters):
            scratch.sum()
            pres[i].record()
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            starts[i].record()
            fn()
            took.append((time.perf_counter() - t0) * 1e3)
            ends[i].record()
        torch.cuda.synchronize()
        spun = [p.elapsed_time(s) for p, s in zip(pres, starts)]
        covered += [s.elapsed_time(e) for s, e, h, sp
                    in zip(starts, ends, took, spun) if h < sp]
        host += took
        spins += spun
    if 2 * len(covered) < iters:
        raise AssertionError(
            f"timing: the host outlasted the spin in "
            f"{len(host) - len(covered)} of {len(host)} calls (host up to "
            f"{max(host):.3f} ms, spin {min(spins):.3f} ms)")
    return {"ms": sum(covered) / len(covered), "host_ms_max": max(host),
            "spin_ms_min": min(spins), "uncovered": len(host) - len(covered),
            "calls": len(host)}


# ------------------------------------------------------------------ phases

def phase_build() -> dict:
    from ai_agent_kubectl_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    took = _cuda.build(_cuda.SOURCES)
    wall = time.monotonic() - t0
    for name in _cuda.SOURCES:
        log_path = _cuda.library_path(name).with_name(
            _cuda.library_path(name).name + ".log")
        if log_path.is_file():
            log(f"[build] ptxas for {name}:\n"
                + log_path.read_text(errors="replace").strip())
    log(f"[build] {len(took)} source(s) compiled in {wall:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in took.items()) or 'cached'})")
    return {"build_s": wall}


def phase_kernel(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain, split_plan)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = 0.0
    before = ragged_attention_pool.launches
    cases = ragged_cases(torch, gen)
    for label, case in cases:
        N, W, H, _ = case["q"].shape
        page = case["k"].shape[1]
        splits, kps, _ = split_plan(N, W, H, case["k"].shape[2],
                                    case["block_tables"].shape[1], page)
        if (splits > 1) != (label in RAGGED_SPLIT_CASES):
            raise AssertionError(f"ragged [{label}]: {splits} key splits")
        out = ragged_attention_pool(**case, page_size=page)
        ref = ragged_attention_pool_plain(**case, page_size=page)
        # Non-finite output would mean a dead or NaN page leaked in.
        err = check_close(torch, f"ragged [{label}]", out, ref)
        frozen = case["q_lens"] == 0
        pad = (torch.arange(out.shape[1], device="cuda")[None, :]
               >= case["q_lens"][:, None])
        log(f"[kernel] ragged {label}: max |kernel - plain| = {err:.3e} "
            f"over {out.numel()} values ({splits} key split(s) of {kps})")
        if (out[frozen] != 0).any() or (out[pad] != 0).any():
            raise AssertionError(f"ragged kernel [{label}]: q_len=0 slots "
                                 f"and padded columns must be exact zeros")
        worst = max(worst, err)
    grew = ragged_attention_pool.launches - before
    if grew != len(cases):
        raise AssertionError(f"launch counter grew by {grew}, expected "
                             f"{len(cases)}")
    out = {"ragged_attention": {"max_abs_err": worst},
           **_kernel_sharded(torch, gen),
           "flash_attention": _kernel_flash(torch, gen),
           "int4_matmul": _kernel_int4(torch, gen),
           "kv_set_slots": _kernel_kv_set_slots(torch, gen),
           **_kernel_paged(torch, gen)}
    for name, got in _kernel_mesh_shards(torch, gen).items():
        key = {"paged_decode_attention": "paged_decode_attention",
               "flash_attention_cached": "flash_attention"}[name]
        out[key]["mesh_shards"] = got
        out[key]["max_abs_err"] = max(out[key]["max_abs_err"],
                                      got["max_abs_err"])
    ring = _kernel_ring_decode(torch, gen)
    row = out["paged_decode_attention"]
    row["ring_decode"] = ring
    row["max_abs_err"] = max(row["max_abs_err"], ring["max_abs_err"])
    return out


def _kernel_mesh_shards(torch, gen) -> dict:
    """The dense ladder's kernels as serve_moe_ep (d) launches them, once
    per (data, model) shard of Mixtral on the one card: the paged decode
    kernel on each shard's 4 slots and 16 over 4 heads of 128 (the
    shard's own [4, S + 1, 4, 128] cache read through its [:, :S] view,
    page 64), and flash on each model shard's heads of a prompt's
    prefill of 128 (KVLEN 128); each shard against its plain
    version, the assembled output against the unsharded kernel, one
    launch per shard."""
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached, flash_attention_cached_plain)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    H_l, KV_l = LLAMA_HEADS // MESH_TP, LLAMA_KV // MESH_TP
    positions = [0, 63, 64, 255, 256, 700, 1000, 1087]
    case = paged_case(torch, gen, page=64, positions=positions,
                      **LLAMA)["dense"]
    rows = N_SLOTS // MESH_DP
    S = case["k"].shape[1]
    worst = {"paged": 0.0, "flash": 0.0}
    before = paged_decode_attention.launches
    blocks = []
    for d in range(MESH_DP):
        r = slice(d * rows, (d + 1) * rows)
        heads = []
        for m in range(MESH_TP):
            kv = []
            for x in (case["k"], case["v"]):
                own = torch.full((rows, S + 1, KV_l, LLAMA_HD), float("nan"),
                                 dtype=x.dtype, device=x.device)
                own[:, :S] = x[r, :, m * KV_l:(m + 1) * KV_l]
                kv.append(own[:, :S])
            shard = dict(q=case["q"][r, m * H_l:(m + 1) * H_l].contiguous(),
                         k=kv[0], v=kv[1],
                         positions=case["positions"][r].contiguous(),
                         page_size=64)
            out = paged_decode_attention(**shard)
            worst["paged"] = max(worst["paged"], check_close(
                torch, f"paged mesh shard (data {d}, model {m})", out,
                paged_decode_attention_plain(**shard)))
            heads.append(out)
        blocks.append(torch.cat(heads, dim=1))
    launched = paged_decode_attention.launches - before
    if launched != MESH_DP * MESH_TP:
        raise AssertionError(f"paged mesh shards: {launched} launches for "
                             f"{MESH_DP * MESH_TP} shards")
    paged_err = check_close(torch, "paged mesh shards assembled",
                            torch.cat(blocks), paged_decode_attention(**case))
    log(f"[kernel] paged dense decode on {MESH_DP}x{MESH_TP} (data, model) "
        f"shards of Mixtral ({rows} slots, {H_l} over {KV_l} heads of "
        f"{LLAMA_HD} a shard): max |kernel - plain| = {worst['paged']:.3e}; "
        f"assembled vs unsharded kernel {paged_err:.3e}")
    fcase = flash_case(torch, gen, S=128, KVLEN=128, **LLAMA)
    before = flash_attention_cached.launches
    heads = []
    for m in range(MESH_TP):
        shard = dict(q=fcase["q"][:, :, m * H_l:(m + 1) * H_l].contiguous(),
                     k=fcase["k"][:, :, m * KV_l:(m + 1) * KV_l].contiguous(),
                     v=fcase["v"][:, :, m * KV_l:(m + 1) * KV_l].contiguous(),
                     positions=fcase["positions"])
        out = flash_attention_cached(**shard)
        worst["flash"] = max(worst["flash"], check_close(
            torch, f"flash mesh shard (model {m})", out,
            flash_attention_cached_plain(**shard)))
        heads.append(out)
    launched = flash_attention_cached.launches - before
    if launched != MESH_TP:
        raise AssertionError(f"flash mesh shards: {launched} launches for "
                             f"{MESH_TP} shards")
    flash_err = check_close(torch, "flash mesh shards assembled",
                            torch.cat(heads, dim=2),
                            flash_attention_cached(**fcase))
    log(f"[kernel] flash prefill (S 128 from 0, KVLEN 128) on {MESH_TP} "
        f"model shards of Mixtral ({H_l} over {KV_l} heads a shard): max "
        f"|kernel - plain| = {worst['flash']:.3e}; assembled vs unsharded "
        f"kernel {flash_err:.3e}")
    return {"paged_decode_attention": {"max_abs_err": worst["paged"],
                                       "assembled_vs_unsharded": paged_err},
            "flash_attention_cached": {"max_abs_err": worst["flash"],
                                       "assembled_vs_unsharded": flash_err}}


#: the sharded wrappers' geometries of phase 2: (label, heads, tp,
#: whether the paged pool kernel runs there too)
TP_KERNEL_GEOMETRIES = (("llama_tp2", "LLAMA", 2, True),
                        ("llama_tp4", "LLAMA", 4, True),
                        ("llama_tp8", "LLAMA", 8, True),
                        ("g7_tp2", "G7", 2, False))
#: phase 2's ragged windows for the sharded wrapper: decode with a frozen
#: slot, and a prefill span of 64 beside decode rows
TP_RAGGED_WINDOWS = (
    ("decode", dict(W=1, positions=[0, 15, 16, 100, 255, 511, 700, 1000],
                    q_lens=[1, 1, 1, 0, 1, 1, 1, 1])),
    # serve_spec_tp's verify window (k = 4) at mixed positions.
    ("verify5", dict(W=SPEC_K + 1,
                     positions=[11, 30, 64, 127, 300, 0, 900, 1017],
                     q_lens=[SPEC_K + 1] * N_SLOTS)),
    ("prefill64", dict(W=64, positions=[0, 0, 64, 17, 300, 0, 500, 900],
                       q_lens=[64, 40, 64, 1, 64, 0, 33, 64])))
#: serve_moe_ep (d)'s mesh on the dense ladder: Mixtral over data x model
#: shards (the expert rows hold the same heads): 8 slots, 4 a data shard,
#: 16 query heads over 4 KV heads of 128 a model shard
MESH_DP, MESH_TP = 2, 2


def _kernel_sharded(torch, gen) -> dict:
    """The two sharded wrappers on ``tp`` shards of the one card: each
    shard's output against the plain version on that shard's heads, the
    assembled output against the unsharded kernel on the same pool, and
    one launch per shard."""
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool, paged_decode_attention_pool_sharded)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_sharded)
    from ai_agent_kubectl_tpu_torch.parallel.mesh import (MeshConfig,
                                                          build_mesh)

    worst = {"ragged": 0.0, "paged": 0.0, "ragged_assembled": 0.0,
             "paged_assembled": 0.0}
    geos = {"LLAMA": LLAMA, "G7": G7}
    for label, geo, tp, paged in TP_KERNEL_GEOMETRIES:
        mesh = build_mesh(MeshConfig(model=tp), [torch.device("cuda", 0)] * tp)
        g = geos[geo]
        calls = [("ragged", w, ragged_case(torch, gen, **kw, **g))
                 for w, kw in TP_RAGGED_WINDOWS]
        if paged:
            positions = [0, 63, 64, 255, 256, 700, 1000, 1087]
            calls.append(("paged", "decode", paged_case(
                torch, gen, page=64, positions=positions, **g)["pool"]))
        for kind, window, case in calls:
            if kind == "ragged":
                page = case["k"].shape[1]
                args = [case[n] for n in ("q", "k", "v", "q_lens",
                                          "positions", "block_tables")]
                wrapper, whole = (ragged_attention_pool_sharded,
                                  ragged_attention_pool)
                head_axis = 2
            else:
                page = case["page_size"]
                args = [case[n] for n in ("q", "k", "v", "positions",
                                          "block_tables")]
                wrapper, whole = (paged_decode_attention_pool_sharded,
                                  paged_decode_attention_pool)
                head_axis = 1
            before = wrapper.launches
            outs = wrapper(*args, mesh, page_size=page)
            if wrapper.launches - before != tp:
                raise AssertionError(
                    f"{kind} sharded [{label} {window}]: "
                    f"{wrapper.launches - before} launches for {tp} shards")
            plains = wrapper(*args, mesh, page_size=page, plain=True)
            for i, (o, p) in enumerate(zip(outs, plains)):
                worst[kind] = max(worst[kind], check_close(
                    torch, f"{kind} sharded [{label} {window}] shard {i}",
                    o, p))
            full = whole(*args, page_size=page)
            err = check_close(torch, f"{kind} sharded [{label} {window}] "
                              f"assembled", torch.cat(outs, dim=head_axis),
                              full)
            worst[f"{kind}_assembled"] = max(worst[f"{kind}_assembled"], err)
            H, KV = args[0].shape[head_axis], args[1].shape[2]
            log(f"[kernel] {kind} sharded {label} {window}: {tp} shards of "
                f"{H // tp} over {KV // tp} heads, max |kernel - plain| = "
                f"{worst[kind]:.3e}; assembled vs unsharded kernel "
                f"{err:.3e}")
    return {"ragged_attention_pool_sharded": {
                "max_abs_err": worst["ragged"],
                "assembled_vs_unsharded": worst["ragged_assembled"]},
            "paged_decode_attention_pool_sharded": {
                "max_abs_err": worst["paged"],
                "assembled_vs_unsharded": worst["paged_assembled"]}}


def _kernel_kv_set_slots(torch, gen) -> dict:
    """Group admission's scatter (``ops/quant.py::kv_set_slots``) on the
    card against its CPU result: a shallow bf16 source (kv_limit rows of
    a dense cache of 1,041) into three slots of eight, its last row
    padding (slot index 8, dropped), and the same on int8 KV leaves.
    Copies only, so the two must be bit-equal."""
    from ai_agent_kubectl_tpu_torch.ops.quant import (kv_quantize,
                                                      kv_set_slots)

    slots = [5, 0, 3, 8]
    out = {}
    for label, quant in (("bf16", False), ("int8", True)):
        dst = torch.randn((4, 8, 1041, 8, 128), generator=gen,
                          device="cuda").to(torch.bfloat16)
        src = torch.randn((4, 4, 128, 8, 128), generator=gen,
                          device="cuda").to(torch.bfloat16)
        if quant:
            dst, src = kv_quantize(dst), kv_quantize(src)
        want = kv_set_slots(
            *(type(x)(**{f: getattr(x, f).cpu() for f in ("q", "s")})
              if quant else x.cpu() for x in (dst, src)), slots)
        got = kv_set_slots(dst, src, slots)
        for a, b in zip(*(((x.q, x.s) if quant else (x,))
                          for x in (got, want))):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"kv_set_slots [{label}]: the card's "
                                     f"scatter differs from the CPU's")
        out[label] = {"slots": slots, "depth": 128}
        log(f"[kernel] kv_set_slots {label}: slots {slots} (8 dropped), a "
            f"128-row source into 1,041 rows: bit-equal to the CPU's")
    return out


def _kernel_paged(torch, gen) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_attention_pool, paged_decode_attention_pool_plain)

    worst = {"dense": 0.0, "pool": 0.0}
    cases = paged_cases(torch, gen)
    before = (paged_decode_attention.launches,
              paged_decode_attention_pool.launches)
    for label, case, (splits, kps, _) in cases:
        if splits < 2:
            raise AssertionError(f"paged [{label}]: the keys must split")
        for kind, kernel, plain in (
                ("dense", paged_decode_attention,
                 paged_decode_attention_plain),
                ("pool", paged_decode_attention_pool,
                 paged_decode_attention_pool_plain)):
            out = kernel(**case[kind])
            ref = plain(**case[kind])
            err = check_close(torch, f"paged {kind} [{label}]", out, ref)
            log(f"[kernel] paged {kind} {label}: max |kernel - plain| = "
                f"{err:.3e} over {out.numel()} values ({splits} key "
                f"split(s) of {kps}; positions "
                f"{case[kind]['positions'].tolist()})")
            worst[kind] = max(worst[kind], err)
    grew = (paged_decode_attention.launches - before[0],
            paged_decode_attention_pool.launches - before[1])
    if grew != (len(cases), len(cases)):
        raise AssertionError(f"paged launch counters grew by {grew}, "
                             f"expected {len(cases)} each")
    return {"paged_decode_attention": {"max_abs_err": worst["dense"]},
            "paged_decode_attention_pool": {"max_abs_err": worst["pool"]}}


def _kernel_flash(torch, gen) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached, flash_attention_cached_plain, split_plan)

    worst = 0.0
    cases = flash_cases(torch, gen)
    before = flash_attention_cached.launches
    for label, case in cases:
        B, S, H, _ = case["q"].shape
        splits, kps, _ = split_plan(B, S, H, case["k"].shape[2],
                                    case["k"].shape[1])
        if (splits > 1) == (label in FLASH_UNSPLIT_CASES):
            raise AssertionError(f"flash [{label}]: {splits} key splits")
        out = flash_attention_cached(**case)
        ref = flash_attention_cached_plain(**case)
        err = check_close(torch, f"flash [{label}]", out, ref)
        dead = case["positions"] < 0
        if (out[dead] != 0).any():
            raise AssertionError(f"flash [{label}]: rows with no visible "
                                 f"key must be exact zeros")
        log(f"[kernel] flash {label}: max |kernel - plain| = {err:.3e} over "
            f"{out.numel()} values (max |plain| "
            f"{float(ref.float().abs().max()):.3f}; {splits} key split(s) "
            f"of {kps})")
        worst = max(worst, err)
    grew = flash_attention_cached.launches - before
    if grew != len(cases):
        raise AssertionError(f"flash launch counter grew by {grew}, "
                             f"expected {len(cases)}")
    return {"max_abs_err": worst, "cases": len(cases)}


def _kernel_int4(torch, gen) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.quant4 import (
        SKINNY_MAX_T, qmatmul4, qmatmul4_plain, split_plan)

    worst = 0.0
    n = 0
    split_tiled = 0
    before = qmatmul4.launches
    for label, x, w in int4_cases(torch, gen):
        T, IN = x.shape
        splits = split_plan(T, IN, w.q.shape[1] * 2, w.group_in)
        split_tiled += T > SKINNY_MAX_T and splits > 1
        out = qmatmul4(x, w)
        ref = qmatmul4_plain(x, w)
        err = check_close(torch, f"int4 [{label}]", out, ref)
        log(f"[kernel] int4 {label}: max |kernel - plain| = {err:.3e} "
            f"(max |plain| {float(ref.float().abs().max()):.3f}; "
            f"{splits} slice(s))")
        worst = max(worst, err)
        n += 1
    grew = qmatmul4.launches - before
    if grew != n:
        raise AssertionError(f"int4 launch counter grew by {grew}, "
                             f"expected {n}")
    if not split_tiled:
        raise AssertionError("no int4 case took the tiled path's "
                             "contraction split")
    return {"max_abs_err": worst, "cases": n,
            "split_tiled_cases": split_tiled}


QUERIES = [
    "list all pods in the default namespace",
    "show the nodes with their labels",
    "describe the deployment named web",
    "get services in kube-system",
    "scale deployment api to 3 replicas",
    "show logs of pod db-0",
    "list configmaps in namespace prod",
    "get events sorted by time",
]
REPEATS = [0, 3]            # served again after the burst: radix hits

# Served-path logits (kernel attention) against the same forward with the
# plain attention, both bf16 on the card: |kernel - plain| <= LOGIT_RTOL
# * rms(plain logits). The two differ only in where attention rounds to
# bf16; the difference compounds over 18 layers and the tied head.
LOGIT_RTOL = 0.05
# Llama-3-8B's untied head gives logits of rms 1.0, so one bf16 ulp of its
# largest logits is 3 % of the rms, and over 32 random layers the plain
# attention itself lands up to 10 % of the rms (max abs) from attention
# computed in f32 (measured on the card, bf16 rounding alone). The
# serve_paged gate therefore takes the larger of LOGIT_RTOL * rms and
# FLOOR_FACTOR times that distance, measured in the same run, on the max
# error, and holds the rms of the error to LOGIT_RTOL * rms.
FLOOR_FACTOR = 1.5


# The served configuration, as the server reads it from the environment.
# Every other knob keeps its default: the block pool and radix cache on,
# ragged attention, 16-token pages and chunks, 128 new tokens, greedy.
SERVE_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": "gemma-2b-it", "DTYPE": "bfloat16",
    "DECODE_BATCH_SIZE": str(N_SLOTS),
    # The `tokenizers` package imports on the card: the BPE asset serves.
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    # The phase sends 11 rate-limited requests (19 with --profile): more
    # than the default 10 a minute from one client.
    "RATE_LIMIT": "1000/minute",
}


class RecordingEngine:
    """The served engine with every ``generate`` result kept, so the
    smoke run can hold each HTTP status against the text the engine
    produced, and every call (streams included) counted. Everything
    else passes through."""

    def __init__(self, inner):
        self.inner = inner
        self.results = []            # (prompt, EngineResult)
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def generate(self, prompt, **kw):
        self.calls += 1
        result = await self.inner.generate(prompt, **kw)
        self.results.append((prompt, result))
        return result

    def generate_stream(self, prompt, **kw):
        self.calls += 1
        return self.inner.generate_stream(prompt, **kw)


def phase_serve(torch, profile: bool = False, bursts: int = 1) -> dict:
    return asyncio.run(_serve(torch, profile, bursts))


def _phase_env(env: dict, port: int) -> None:
    """The process environment one serving phase reads: the script's
    starting environment, the phase's knobs and the address."""
    os.environ.clear()
    os.environ.update(START_ENV, **env, HOST="127.0.0.1", PORT=str(port))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _serve(torch, profile: bool, bursts: int) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    port = _free_port()
    _phase_env(SERVE_ENV, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    log(f"[serve] {cfg.model_name} up on {cfg.host}:{port} in "
        f"{startup_s:.1f} s ({inner.device}, {inner.batch_size} slots, "
        f"pool {inner._pool_n_blocks} blocks)")
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["devices"] != 1:
                    raise AssertionError(f"/health: {r.status} {health}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            ragged_attention_pool.launches = 0
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            burst_s = time.monotonic() - t_burst
            burst_steps = inner.forward_steps - steps0
            t_rep = time.monotonic()
            repeats = [await ask(QUERIES[i]) for i in REPEATS]
            repeat_s = time.monotonic() - t_rep
            launches = ragged_attention_pool.launches
            steps = inner.forward_steps - steps0
            # --bursts: more bursts of fresh queries, each timed alone
            # (the first is the counted one above).
            more = []
            for k in range(1, bursts):
                n0 = len(engine.results)
                t_k = time.monotonic()
                await asyncio.gather(*[ask(f"{q} (burst {k})")
                                       for q in QUERIES])
                took = time.monotonic() - t_k
                more.append(sum(r.completion_tokens
                                for _, r in engine.results[n0:]) / took)
            async with http.post(f"{url}/kubectl-command",
                                 json={"query": "x"}) as r:
                if r.status != 400:
                    raise AssertionError(f"short query gave {r.status}")
            profiled = (await _profile_burst(
                torch, ask, [q + " now" for q in QUERIES],
                lambda: inner.forward_steps, "forward steps", "profile")
                if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    cfg_model = inner.model_cfg
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [s for s, _ in burst + repeats]
    for query, (status, body) in zip(QUERIES + [QUERIES[i] for i in REPEATS],
                                     burst + repeats):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{query!r}: no tokens generated")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{query!r}: HTTP {status}, the service "
                                 f"gives {want} for {res.text!r}: {body}")
    for i in REPEATS:
        first, again = results[render_prompt(QUERIES[i])]
        if again.token_ids != first.token_ids:
            raise AssertionError(f"repeat of {QUERIES[i]!r} changed its "
                                 f"greedy tokens")
        if not again.prefix_cache_hit:
            raise AssertionError(f"repeat of {QUERIES[i]!r} missed the "
                                 f"radix cache")
    if launches < cfg_model.n_layers * steps or steps <= 0:
        raise AssertionError(f"attention kernel launched {launches} times "
                             f"for {steps} forward steps x "
                             f"{cfg_model.n_layers} layers")
    check_pool_books(inner)

    logit_check = _check_served_logits(torch, inner, results)
    firsts = [results[render_prompt(q)][0] for q in QUERIES]
    n_tok = sum(r.completion_tokens for r in firsts)
    ttft = sorted(r.ttft_ms for r in firsts)
    info = {
        "startup_s": startup_s,
        "launches": launches,
        "forward_steps": steps,
        "launches_per_step": launches / steps,
        "statuses": statuses,
        "burst_requests": len(QUERIES),
        "burst_s": burst_s,
        "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s,
        "burst_forward_steps": burst_steps,
        "more_bursts_tok_per_s": more,
        "ttft_ms_p50": ttft[len(ttft) // 2],
        "ttft_ms_max": ttft[-1],
        "repeat_s": repeat_s,
        "repeat_prefix_hits": len(REPEATS),
        "logits": logit_check,
        "decode_positions": [r.prompt_tokens + r.completion_tokens // 2
                             for r in firsts],
        "profile": profiled,
    }
    log(f"[serve] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} s "
        f"({n_tok / burst_s:.1f} tok/s), TTFT p50 {info['ttft_ms_p50']:.0f}"
        f" ms max {info['ttft_ms_max']:.0f} ms; kernel launches {launches} "
        f"over {steps} forward steps ({launches / steps:.0f} per step)"
        + (f"; more bursts {', '.join(f'{t:.1f}' for t in more)} tok/s"
           if more else ""))
    return info


def check_pool_books(inner) -> None:
    """The pool's books after a drain: every block free or held by a
    live slot or the radix tree, exactly, and with the host tier on
    every resident host page held by one node (``BlockPool.check``
    raises)."""
    holders: dict = {}
    for slot in inner._slots:
        for b in (slot.blocks or []) if slot is not None else []:
            holders[b] = holders.get(b, 0) + 1
    if inner._radix is not None:
        for b, n in inner._radix._held.items():
            holders[b] = holders.get(b, 0) + n
    host = inner._host_store
    inner._pool.check(holders, host=host,
                      host_holders=(inner._radix.host_holders()
                                    if host is not None else None))


async def _profile_burst(torch, ask, queries, steps, unit: str,
                         tag: str) -> dict:
    """Fresh queries (sent together) under ``torch.profiler``, after the
    counted run: the device's busy share of the wall time and the kernels
    that take it, logged as a table and as one ``[<tag>] json`` line.
    ``steps()`` reads a cumulative count (forward steps, or generated
    tokens) that the per-step figures divide by. Only with
    ``--profile``."""
    from torch.profiler import ProfilerActivity, profile

    steps0 = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        await asyncio.gather(*[ask(q) for q in queries])
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    n_steps = steps() - steps0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                     # host ops: their kernels count
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, float(dev_us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    out = {
        "wall_ms": wall_s * 1e3, "steps": n_steps, "step_unit": unit,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (wall_s * 1e3),
        "kernel_calls_per_step": sum(r[2] for r in rows) / max(n_steps, 1),
        "top": [{"name": k[:120], "device_ms": us / 1e3, "calls": n,
                 "share_of_device": us / 1e3 / device_ms if device_ms else 0}
                for k, us, n in rows[:15]],
    }
    log(f"[{tag}] {len(queries)} requests, {n_steps} {unit} in "
        f"{wall_s * 1e3:.0f} ms wall; device busy {device_ms:.0f} ms "
        f"({out['device_busy_share']:.1%}); "
        f"{out['kernel_calls_per_step']:.0f} kernels per {unit[:-1]}")
    for r in out["top"]:
        log(f"[{tag}]   {r['device_ms']:9.2f} ms {r['calls']:7d} calls "
            f"{r['share_of_device']:6.1%}  {r['name']}")
    log(f"[{tag}] json " + json.dumps(out))
    return out


def _kernel_and_plain(torch, run) -> tuple:
    """``run()`` on the kernels, then with the forward's ragged, flash and
    int4 entry points set to their plain versions (a call to a kernel
    the forward does not reach is a no-op swap)."""
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.ops import quant
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached_plain)
    from ai_agent_kubectl_tpu_torch.ops.quant4 import qmatmul4_plain
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool_plain)

    swaps = [(transformer, "ragged_attention_pool",
              ragged_attention_pool_plain),
             (transformer, "flash_attention_cached",
              flash_attention_cached_plain),
             (quant, "qmatmul4", qmatmul4_plain)]
    with torch.no_grad():
        kernel = run()
        saved = [getattr(m, n) for m, n, _ in swaps]
        for m, n, plain in swaps:
            setattr(m, n, plain)
        try:
            plain = run()
        finally:
            for (m, n, _), fn in zip(swaps, saved):
                setattr(m, n, fn)
    return kernel, plain


def _logit_gate(torch, kernel, plain, served: int, what: str,
                tag: str) -> dict:
    """Max |kernel - plain| within LOGIT_RTOL of the plain logits' rms,
    and the served first token the kernel forward's argmax up to the
    same tolerance."""
    rms = float(plain.pow(2).mean().sqrt())
    err = float((kernel - plain).abs().max())
    tol = LOGIT_RTOL * rms
    gap = float(kernel.max()) - float(kernel[served])
    log(f"[{tag}] first-step logits {what}: max |kernel - plain| "
        f"{err:.4f} (rms {rms:.3f}, tolerance {tol:.4f}); served token "
        f"{served} sits {gap:.4f} below the kernel argmax "
        f"{int(kernel.argmax())}")
    if not torch.isfinite(kernel).all() or err > tol:
        raise AssertionError(f"{tag}: served-path logits disagree with the "
                             f"plain forward: {err} > {tol}")
    if gap > tol:
        raise AssertionError(f"{tag}: served first token {served} is {gap} "
                             f"below the argmax (tolerance {tol})")
    return {"max_abs_err": err, "rms": rms, "tolerance": tol,
            "served_gap": gap}


def _check_served_logits(torch, engine, results, tag="serve") -> dict:
    """First-step logits of one served prompt through the serving pool
    forward (ragged attention, and int4 projections where the tree has
    them) against the same forward on the plain versions, on the card;
    and the served first token must be the kernel forward's argmax up to
    that tolerance."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.models import transformer

    res = results[render_prompt(QUERIES[0])][0]
    ids = engine.tokenizer.encode(render_prompt(QUERIES[0]))
    P = len(ids)
    pages = -(-P // PAGE)
    dev = engine.device
    tokens = torch.tensor([ids], device=dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None]
    tables = torch.arange(pages, dtype=torch.int32, device=dev)[None]

    def run():
        cache = transformer.KVCache.pool(engine.model_cfg, pages, PAGE,
                                         dtype=engine.dtype, device=dev)
        logits, _ = transformer.forward(
            engine.params, engine.model_cfg, tokens, positions, cache,
            block_tables=tables,
            logits_at=torch.tensor([P - 1], device=dev))
        return logits[0, 0].float()

    kernel, plain = _kernel_and_plain(torch, run)
    return dict(_logit_gate(torch, kernel, plain, int(res.token_ids[0]),
                            f"over {P} prompt tokens", tag),
                prompt_tokens=P)


# The single-sequence configuration of phase 4, as the server reads it.
# Every other knob keeps its default: MAX_SEQ_LEN 1024, 128 new tokens,
# greedy, the system-prompt prefix cache on, ATTN_IMPL=auto (flash).
SERVE1_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": "gemma-7b-it", "DTYPE": "bfloat16", "QUANT": "int4",
    "DECODE_BATCH_SIZE": "1", "PREFILL_BUCKETS": "64,128,256,512",
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
}
SERVE1_QUERIES = [
    "list all pods in the default namespace",
    "get services in kube-system",
    "show logs of pod db-0",
]
SERVE1_REPEATS = 2           # the first query again, twice
# Repeated until the query's suffix past the cached prefix exceeds the
# largest prefill bucket by a margin (about 600 tokens of prompt).
LONG_SENTENCE = ("show every pod in every namespace that restarted more "
                 "than five times today and sort them by node name")


def phase_serve1(torch, profile: bool = False) -> dict:
    return asyncio.run(_serve1(torch, profile))


def _long_query(engine) -> str:
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    biggest = engine.prefill_buckets[-1]
    reps = 1
    while True:
        query = " ".join([LONG_SENTENCE] * reps)
        n = len(engine.tokenizer.encode(render_prompt(query)))
        if n - engine._prefix.n > biggest + 64:
            return query
        reps += 1


async def _serve1(torch, profile: bool) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.quant4 import qmatmul4
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    port = _free_port()
    _phase_env(SERVE1_ENV, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if type(inner) is not TorchEngine:
        raise AssertionError(f"engine construction failed: {inner!r}")
    chunked = []                         # (prompt tokens, start) per call
    prefill_chunked = inner._prefill_chunked

    def counting(prompt_ids, cache=None, start=0):
        chunked.append((len(prompt_ids), start))
        return prefill_chunked(prompt_ids, cache=cache, start=start)

    inner._prefill_chunked = counting
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    if inner._prefix is None:
        raise AssertionError("the system-prompt prefix cache was not built")
    weight_gb = sum(
        t.numel() * t.element_size() for t in _leaves(inner.params)) / 1e9
    log(f"[serve1] {cfg.model_name} quant={inner.quant} up on "
        f"{cfg.host}:{port} in {startup_s:.1f} s ({inner.device}, weights "
        f"{weight_gb:.3f} GB, prefix {inner._prefix.n} tokens, prefill "
        f"{inner.attn_impl})")
    queries = (SERVE1_QUERIES + [_long_query(inner)]
               + [SERVE1_QUERIES[0]] * SERVE1_REPEATS)
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["engine"] != "torch":
                    raise AssertionError(f"/health: {r.status} {health}")
            engine.results.clear()
            chunked.clear()
            flash_attention_cached.launches = 0
            qmatmul4.launches = 0
            replies = []
            t_all = time.monotonic()
            for query in queries:
                replies.append(await ask(query))
            wall_s = time.monotonic() - t_all
            launches = {"flash_attention": flash_attention_cached.launches,
                        "int4_matmul": qmatmul4.launches}
            results = [res for _, res in engine.results]
            profiled = (await _profile_burst(
                torch, ask, [SERVE1_QUERIES[1] + " now"],
                lambda: sum(r.completion_tokens for _, r in engine.results),
                "tokens", "profile1") if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    if len(results) != len(queries):
        raise AssertionError(f"{len(results)} results for {len(queries)} "
                             f"queries")
    for query, (status, body), res in zip(queries, replies, results):
        if res.completion_tokens <= 0:
            raise AssertionError(f"{query[:40]!r}: no tokens generated")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{query[:40]!r}: HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}: "
                                 f"{body}")
        if not res.prefix_cache_hit:
            raise AssertionError(f"{query[:40]!r} missed the system-prompt "
                                 f"prefix cache")
    long_res = results[len(SERVE1_QUERIES)]
    suffix = long_res.prompt_tokens - inner._prefix.n
    if (suffix <= inner.prefill_buckets[-1]
            or (long_res.prompt_tokens, inner._prefix.n) not in chunked):
        raise AssertionError(f"the long query ({long_res.prompt_tokens} "
                             f"tokens) did not take the chunked suffix "
                             f"prefill: {chunked}")
    for again in results[len(SERVE1_QUERIES) + 1:]:
        if again.token_ids != results[0].token_ids:
            raise AssertionError("a repeat changed its greedy tokens")
    n_layers = inner.model_cfg.n_layers
    if (launches["flash_attention"] < n_layers
            or launches["int4_matmul"] < 7 * n_layers):
        raise AssertionError(f"kernel launches in the serve1 run: "
                             f"{launches}")
    logit_check = _check_served_logits1(torch, inner, results[0],
                                        render_prompt(SERVE1_QUERIES[0]))
    short = results[:len(SERVE1_QUERIES)]
    decode_tps = [r.completion_tokens / (r.decode_ms / 1e3) for r in short]
    info = {
        "startup_s": startup_s,
        "weight_gb": weight_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "statuses": [st for st, _ in replies],
        "requests": len(queries),
        "wall_s": wall_s,
        "tokens": sum(r.completion_tokens for r in results),
        "tok_per_s": sum(r.completion_tokens for r in results) / wall_s,
        "decode_tok_per_s": decode_tps,
        "ttft_ms": [r.ttft_ms for r in short],
        "long_prompt_tokens": long_res.prompt_tokens,
        "long_ttft_ms": long_res.ttft_ms,
        "chunked_prefills": chunked,
        "logits": logit_check,
        "decode_positions": [r.prompt_tokens + r.completion_tokens // 2
                             for r in short],
        "profile": profiled,
    }
    log(f"[serve1] statuses {info['statuses']}; {info['tokens']} tokens "
        f"over {len(queries)} sequential requests in {wall_s:.2f} s "
        f"({info['tok_per_s']:.1f} tok/s); decode "
        f"{', '.join(f'{t:.1f}' for t in decode_tps)} tok/s; TTFT "
        f"{', '.join(f'{t:.0f}' for t in info['ttft_ms'])} ms (prefix hits),"
        f" {long_res.ttft_ms:.0f} ms for the {long_res.prompt_tokens}-token "
        f"prompt; launches {launches}; peak "
        f"{info['peak_mem_gb']:.2f} GB")
    return info


def _leaves(tree):
    if isinstance(tree, dict):
        for val in tree.values():
            yield from _leaves(val)
    elif hasattr(tree, "q"):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def _check_served_logits1(torch, engine, res, prompt,
                          tag="serve1") -> dict:
    """One served prompt prefilled from scratch through the engine's
    forward (flash and int4 kernels; in chunks of the largest bucket
    past it, as the engine prefills a long prompt) against the same
    forward with both plain versions, on the card; and the served first
    token (which came through the prefix-cache suffix path) must be the
    kernel forward's argmax up to that tolerance."""
    ids = engine.tokenizer.encode(prompt)

    def run():
        return engine._prefill_chunked(ids)[0][0].float()

    kernel, plain = _kernel_and_plain(torch, run)
    return dict(_logit_gate(torch, kernel, plain, int(res.token_ids[0]),
                            f"over {len(ids)} prompt tokens", tag),
                prompt_tokens=len(ids))


# The paged-decode configuration of phase 5, as the server reads it; each
# engine adds its KV layout. Every other knob keeps its default: 16-token
# chunks, 128 new tokens, greedy, the prefix and radix caches on.
SERVE_PAGED_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": "llama-3-8b-instruct", "DTYPE": "bfloat16", "QUANT": "",
    "DECODE_BATCH_SIZE": str(N_SLOTS), "MAX_SEQ_LEN": "1024",
    "PREFILL_BUCKETS": "64,128,256,512", "DECODE_ATTN": "auto",
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    # Each engine takes 10 rate-limited requests (18 with --profile).
    "RATE_LIMIT": "1000/minute",
}
SERVE_PAGED_ENGINES = {
    "dense": {"KV_POOL": "false", "RAGGED_ATTENTION": "auto"},
    "pool": {"KV_POOL": "true", "RAGGED_ATTENTION": "off"},
}
LONG_PROMPT_TOKENS = 600    # the burst's long query, rendered


def phase_serve_paged(torch, profile: bool = False) -> dict:
    return asyncio.run(_serve_paged(torch, profile))


def _long_burst_query(tokenizer) -> str:
    """LONG_SENTENCE repeated until the rendered prompt reaches about
    LONG_PROMPT_TOKENS tokens."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    reps = 1
    while True:
        query = " ".join([LONG_SENTENCE] * reps)
        if len(tokenizer.encode(render_prompt(query))) >= LONG_PROMPT_TOKENS:
            return query
        reps += 1


async def _serve_paged(torch, profile: bool) -> dict:
    """Both engines of phase 5 in turn on one parameter tree (the first
    engine draws it, the others are handed it); after (a), its group
    admission's single-admission reference."""
    params = None
    out = {}
    for kind, env in SERVE_PAGED_ENGINES.items():
        out[kind], params = await _serve_paged_one(torch, kind, env, params,
                                                   profile)
        if kind == "dense":
            out["group"] = await _serve_paged_reference(torch, params,
                                                        out[kind])
    return out


class _HeldPop:
    """Holds an idle batched engine's next queue pop until a whole burst
    is queued, then lets that pop come back empty: the scheduler's next
    pass pops the burst at once, as it pops a burst that arrives between
    two passes, so prefix hits sharing a suffix shape admit as one
    group."""

    def __init__(self, inner):
        import queue
        import threading

        self.q, self.empty = inner._admissions, queue.Empty
        self.held, self.opened = threading.Event(), threading.Event()
        self.q.get = self._hold

    def _hold(self, *args, **kw):
        self.held.set()
        self.opened.wait(60.0)
        raise self.empty

    async def _until(self, cond, what: str) -> None:
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > 60.0:
                raise AssertionError(f"{what} within 60 s "
                                     f"({self.q.qsize()} queued)")
            await asyncio.sleep(0.002)

    async def idle(self) -> None:
        """Until the scheduler waits at the held pop."""
        await self._until(self.held.is_set, "the scheduler never idled")

    async def release_when_queued(self, n: int) -> None:
        await self._until(lambda: self.q.qsize() >= n,
                          f"the burst of {n} never queued")
        self.restore()

    def restore(self) -> None:
        self.q.__dict__.pop("get", None)
        self.opened.set()


class _GroupFlashTap:
    """Flash attention wrapped where the model calls it: every call with
    more than one row (a group admission's prefill; every other flash
    call of the dense ladder has one) is counted by its shape, and the
    latest at each shape keeps a copy of its inputs on the card, taken
    before the launch with no host sync, so ``check`` holds the kernel
    against its plain version on the traffic's own inputs."""

    def __init__(self, torch):
        from ai_agent_kubectl_tpu_torch.models import transformer

        self.torch, self.module = torch, transformer
        self.real = transformer.flash_attention_cached
        self.inputs: dict = {}
        self.launches: dict = {}
        transformer.flash_attention_cached = self._call

    def _call(self, q, k, v, positions, **kw):
        if q.shape[0] > 1:
            key = (tuple(q.shape), tuple(k.shape))
            self.launches[key] = self.launches.get(key, 0) + 1
            self.inputs[key] = ([x.clone() for x in (q, k, v, positions)],
                                dict(kw))
        return self.real(q, k, v, positions, **kw)

    def restore(self) -> None:
        self.module.flash_attention_cached = self.real

    def check(self, tag: str, kpad: int) -> list:
        """Every group call at B = ``kpad`` and at a shape phase 2 holds
        (GROUP_FLASH, from the prefix length on); then the kernel against
        its plain version on the captured inputs."""
        from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
            flash_attention_cached_plain)

        held = {(B, S, KVLEN, geom["H"], geom["KV"], geom["hd"])
                for _, geom, B, S, KVLEN, _ in GROUP_FLASH}
        P = group_prefix_tokens()
        if not self.inputs:
            raise AssertionError(f"{tag}: no group prefill reached flash")
        out = []
        for key, (args, kw) in self.inputs.items():
            q, k, _, pos = args
            B, S, H, hd = q.shape
            shape = (B, S, k.shape[1], H, k.shape[2], hd)
            offsets = set(pos[:, 0].tolist())
            if B != kpad or shape not in held or offsets != {P}:
                raise AssertionError(f"{tag}: flash ran at {shape} from "
                                     f"{offsets}, not a group shape phase 2 "
                                     f"holds at kpad {kpad} from {P}")
            err = check_close(self.torch, f"{tag} group flash {shape}",
                              self.real(*args, **kw),
                              flash_attention_cached_plain(*args, **kw))
            at = {"B": B, "S": S, "KVLEN": k.shape[1], "offset": P,
                  "launches": self.launches[key], "max_abs_err": err}
            out.append(at)
            log(f"[{tag}] group flash at {at} on the traffic's own inputs")
        return out


async def _serve_paged_reference(torch, params, grouped: dict) -> dict:
    """serve_paged (a)'s burst again on an engine built from the same
    environment-style config and weights with ADMIT_SCRATCH_MB=1, which
    caps every kpad to 0 at Llama-3-8B's scratch rows (16.8 MB at kv_limit
    128): every request admits singly. Gates: no group; each burst
    transcript equal to (a)'s, or apart first at a near tie; the books
    balance. Printed: the group's first-token ms against the singles'."""
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine

    import aiohttp

    tag = "serve_paged/dense-singles"
    port = _free_port()
    _phase_env({**SERVE_PAGED_ENV, **SERVE_PAGED_ENGINES["dense"],
                "ADMIT_SCRATCH_MB": "1"}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    inner.params = params
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    queries = grouped["burst_queries"]
    try:
        kv_limit = grouped["group"]["key"][1]
        if inner.admit_kpads_for(kv_limit):
            raise AssertionError(f"{tag}: ADMIT_SCRATCH_MB=1 left kpads "
                                 f"{inner.admit_kpads_for(kv_limit)}")
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"http://{cfg.host}:{port}"
                                     f"/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            hold = _HeldPop(inner)
            try:
                await hold.idle()
                tasks = [asyncio.ensure_future(ask(q)) for q in queries]
                await hold.release_when_queued(len(queries))
                statuses = [st for st, _ in await asyncio.gather(*tasks)]
            finally:
                hold.restore()
    finally:
        await runner.cleanup()
    if inner._group_admitted:
        raise AssertionError(f"{tag}: {inner._group_admitted} groups")
    if any(s is not None for s in inner._slots) or \
            inner.stats()["kv_pages_used"]:
        raise AssertionError(f"{tag}: the books do not balance")
    singles = {p: r for p, r in engine.results}
    ties = []
    for q in queries:
        prompt = render_prompt(q)
        want = grouped["burst_ids"][prompt]
        got = list(singles[prompt].token_ids)
        gap = _first_mismatch(torch, inner, inner.tokenizer.encode(prompt),
                              want, got, 0.0, 0)
        if gap is not None:
            if gap["gap"] > gap["tolerance"]:
                raise AssertionError(f"{tag} {q[:40]!r}: the group's "
                                     f"transcript leaves the single's at "
                                     f"{gap}, not a near tie")
            ties.append(gap)
            log(f"[{tag}] {q[:40]!r}: apart at a near tie {gap}")
    members = grouped["group_prompts"]
    g_ttft = sorted(grouped["burst_ttft"][p] for p in members)
    s_ttft = sorted(singles[p].ttft_ms for p in members)
    info = {"statuses": statuses, "near_ties": ties,
            "identical": len(queries) - len(ties),
            "group_ttft_ms_p50": g_ttft[len(g_ttft) // 2],
            "single_ttft_ms_p50": s_ttft[len(s_ttft) // 2],
            "group_ttft_ms_max": g_ttft[-1],
            "single_ttft_ms_max": s_ttft[-1]}
    log(f"[{tag}] {info['identical']} of {len(queries)} transcripts "
        f"identical to the group's, {len(ties)} apart at a near tie; the "
        f"group's {len(members)} first tokens p50 "
        f"{info['group_ttft_ms_p50']:.1f} ms (max "
        f"{info['group_ttft_ms_max']:.1f}) against "
        f"{info['single_ttft_ms_p50']:.1f} ms (max "
        f"{info['single_ttft_ms_max']:.1f}) admitted singly; "
        f"{gpu_line()}")
    return info


async def _serve_paged_one(torch, kind: str, env: dict, params,
                           profile: bool):
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_paged/{kind}"
    port = _free_port()
    _phase_env({**SERVE_PAGED_ENV, **env}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    if params is not None:
        inner.params = params
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    page = inner.kv_pool_page if inner.kv_pool else inner.kv_page_size
    kernel = (paged_decode_attention_pool if inner.kv_pool
              else paged_decode_attention)
    log(f"[{tag}] {cfg.model_name} up on {cfg.host}:{port} in "
        f"{startup_s:.1f} s ({inner.device}, {inner.batch_size} slots, "
        f"regime {inner._attention_regime}, decode {inner._decode_impl} at "
        f"page {page}, KV span {inner._S_alloc})")
    if inner._decode_impl != "paged" or page != 64:
        raise AssertionError(f"{tag}: DECODE_ATTN=auto resolved to "
                             f"{inner._decode_impl} at page {page}")
    queries = list(QUERIES)
    queries[-1] = _long_burst_query(inner.tokenizer)
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["devices"] != 1:
                    raise AssertionError(f"/health: {r.status} {health}")
                regime = (health["kv_pool"] or {}).get("attention_regime")
                if regime != (inner._attention_regime if inner.kv_pool
                              else None):
                    raise AssertionError(f"/health regime {regime}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            # The dense ladder's burst admits at one pass (held until the
            # whole burst is queued): its prefix hits take the group path.
            groups0 = inner._group_admitted
            tap = None if inner.kv_pool else _GroupFlashTap(torch)
            hold = None if inner.kv_pool else _HeldPop(inner)
            for fn in (paged_decode_attention, paged_decode_attention_pool,
                       flash_attention_cached, ragged_attention_pool):
                fn.launches = 0
            steps0 = inner.decode_steps
            hits0 = inner._radix.hit_tokens_total if inner.kv_pool else 0
            t_burst = time.monotonic()
            try:
                if hold is not None:
                    await hold.idle()
                tasks = [asyncio.ensure_future(ask(q)) for q in queries]
                if hold is not None:
                    await hold.release_when_queued(len(queries))
                burst = await asyncio.gather(*tasks)
            finally:
                if hold is not None:
                    hold.restore()
                if tap is not None:
                    tap.restore()
            burst_s = time.monotonic() - t_burst
            groups = inner._group_admitted - groups0
            hits1 = inner._radix.hit_tokens_total if inner.kv_pool else 0
            repeats = [await ask(queries[i]) for i in REPEATS]
            hits2 = inner._radix.hit_tokens_total if inner.kv_pool else 0
            launches = {
                "paged": kernel.launches,
                "other_paged": (paged_decode_attention.launches
                                + paged_decode_attention_pool.launches
                                - kernel.launches),
                "flash": flash_attention_cached.launches,
                "ragged": ragged_attention_pool.launches}
            if tap is not None:
                launches["flash_group"] = sum(tap.launches.values())
            steps = inner.decode_steps - steps0
            profiled = (await _profile_burst(
                torch, ask, [q + " now" for q in QUERIES],
                lambda: inner.decode_steps, "decode steps",
                f"profile_{kind}") if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    n_layers = inner.model_cfg.n_layers
    if (steps <= 0 or launches["paged"] != n_layers * steps
            or launches["other_paged"] or launches["ragged"]):
        raise AssertionError(f"{tag}: launches {launches} for {steps} "
                             f"decode steps x {n_layers} layers")
    if launches["flash"] < n_layers:
        raise AssertionError(f"{tag}: flash never ran on the prefills "
                             f"({launches})")
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [st for st, _ in burst + repeats]
    for query, (status, body) in zip(queries + [queries[i] for i in REPEATS],
                                     burst + repeats):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{tag} {query[:40]!r}: no tokens")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{tag} {query[:40]!r}: HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}: "
                                 f"{body}")
    firsts = [results[render_prompt(q)][0] for q in queries]
    repeat_ties = []
    for i in REPEATS:
        first, again = results[render_prompt(queries[i])]
        if again.token_ids != first.token_ids:
            # A group-admitted request's repeat admits singly: its
            # prefill's GEMMs run 64 rows where the group's ran kpad x 64,
            # and bf16 may round the two apart (only at a near tie).
            gap = (None if tap is None else _first_mismatch(
                torch, inner, inner.tokenizer.encode(
                    render_prompt(queries[i])),
                first.token_ids, again.token_ids, 0.0, 0))
            if gap is None or gap["gap"] > gap["tolerance"]:
                raise AssertionError(f"{tag}: the repeat of {queries[i]!r} "
                                     f"changed its greedy tokens ({gap})")
            repeat_ties.append(gap)
            log(f"[{tag}] the single-admitted repeat of {queries[i]!r} "
                f"leaves its group-admitted transcript at a near tie {gap}")
        if not again.prefix_cache_hit:
            raise AssertionError(f"{tag}: the repeat of {queries[i]!r} "
                                 f"missed its prefix")
    if inner.kv_pool:
        # The repeats re-map their own cached chains: at least every full
        # page of each prompt, beyond what the burst matched.
        want_hits = sum(firsts[i].prompt_tokens - page for i in REPEATS)
        if hits2 - hits1 < want_hits:
            raise AssertionError(f"{tag}: the repeats radix-matched "
                                 f"{hits2 - hits1} tokens, want >= "
                                 f"{want_hits}")
        check_pool_books(inner)
    n_tok = sum(r.completion_tokens for r in firsts)
    ttft = sorted(r.ttft_ms for r in firsts)
    info = {
        "regime": inner._attention_regime, "page": page,
        "kv_span": inner._S_alloc,
        "startup_s": startup_s,
        "launches": launches,
        "decode_steps": steps,
        "statuses": statuses,
        "burst_requests": len(queries),
        "burst_s": burst_s,
        "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s,
        "ttft_ms_p50": ttft[len(ttft) // 2],
        "ttft_ms_max": ttft[-1],
        "prompt_tokens": [r.prompt_tokens for r in firsts],
        "radix_hit_tokens": [hits1 - hits0, hits2 - hits1],
        "final_positions": [r.prompt_tokens + r.completion_tokens
                            for r in firsts],
        "profile": profiled,
        "repeat_near_ties": repeat_ties,
    }
    if tap is not None:
        # Group admission: the burst's prefix hits share one suffix shape
        # and admit as one group of kpad rows through flash.
        from types import SimpleNamespace

        keys = {}
        for q in queries:
            prompt = render_prompt(q)
            key = inner._suffix_group_key(SimpleNamespace(
                prompt_ids=inner.tokenizer.encode(prompt), resume_ids=None,
                max_tokens=cfg.max_new_tokens, gpid=-1))
            if key is not None:
                keys.setdefault(key, []).append(prompt)
        if len(keys) != 1:
            raise AssertionError(f"{tag}: the burst's prefix hits take "
                                 f"suffix shapes {list(keys)}, not one")
        (key, hits), = keys.items()
        kpad = next(k for k in inner.admit_kpads if k >= len(hits))
        if groups != 1 or len(hits) < 2:
            raise AssertionError(f"{tag}: {groups} group admissions for the "
                                 f"burst's {len(hits)} hits at {key}")
        info["group"] = {"admissions": groups, "rows": len(hits),
                         "kpad": kpad, "key": list(key),
                         "flash": tap.check(tag, kpad)}
        if launches["flash_group"] != n_layers:
            raise AssertionError(f"{tag}: {launches['flash_group']} group "
                                 f"flash launches, want one forward's "
                                 f"{n_layers}")
        if inner.stats()["kv_pages_used"]:
            raise AssertionError(f"{tag}: the books do not balance")
        info["burst_queries"] = queries
        info["group_prompts"] = hits
        info["burst_ids"] = {render_prompt(q): list(r.token_ids)
                             for q, r in zip(queries, firsts)}
        info["burst_ttft"] = {render_prompt(q): r.ttft_ms
                              for q, r in zip(queries, firsts)}
        log(f"[{tag}] group admission: {len(hits)} prefix hits in one group "
            f"of kpad {kpad}, {launches['flash_group']} flash launches at "
            f"B = {kpad}")
    log(f"[{tag}] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} s "
        f"({n_tok / burst_s:.1f} tok/s), TTFT p50 {info['ttft_ms_p50']:.0f} "
        f"ms max {info['ttft_ms_max']:.0f} ms; prompts "
        f"{info['prompt_tokens']}; launches {launches} over {steps} decode "
        f"steps")
    info["logits"] = _check_paged_logits(torch, inner, firsts[0],
                                         render_prompt(queries[0]), tag)
    return info, inner.params


def _check_paged_logits(torch, engine, res, prompt, tag) -> dict:
    """One served prompt through the engine's forward from scratch — its
    prefill (flash, the gather path on the pool) and one decode step fed
    the served first token (the paged kernel) — against the same two
    forwards on the plain versions, on the card. Each served token must
    be the kernel forward's argmax up to the tolerance. Two wrong
    stand-ins for the paged kernel (the plain version with each slot's
    last key dropped, and reading the next KV head) must fail the decode
    step's gate, or the gate could not tell a wrong kernel."""
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached_plain)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention_plain, paged_decode_attention_pool_plain)

    cfg, dev = engine.model_cfg, engine.device
    ids = engine.tokenizer.encode(prompt)
    P = len(ids)
    # The served prefill's shape: the pool's one gather shape, the dense
    # ladder's bucket.
    bucket, kv_limit = (engine._pool_prefill_shape(P) if engine.kv_pool
                        else (engine._bucket_for(P),) * 2)
    if bucket < P:
        raise AssertionError(f"{tag}: the check's prompt of {P} tokens "
                             f"needs more than one window")
    page = engine.kv_pool_page if engine.kv_pool else engine.kv_page_size
    cols = torch.arange(bucket, dtype=torch.int32, device=dev)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :P] = torch.tensor(ids, device=dev)
    served = [int(t) for t in res.token_ids[:2]]

    def run():
        if engine.kv_pool:
            pages = engine._pool_max_pages
            cache = transformer.KVCache.pool(cfg, pages, page,
                                             dtype=engine.dtype, device=dev)
            kw = dict(block_tables=torch.arange(
                pages, dtype=torch.int32, device=dev)[None])
        else:
            cache = transformer.KVCache.zeros(cfg, 1, engine._S_alloc,
                                              dtype=engine.dtype, device=dev)
            kw = {}
        impl = engine._prefill_impl_for(bucket, kv_limit)
        first, _ = transformer.forward(
            engine.params, cfg, tokens, cols[None], cache,
            kv_limit=kv_limit, attn_impl=impl, write_mask=(cols < P)[None],
            logits_at=torch.tensor([P - 1], device=dev), **kw)
        second, _ = transformer.forward(
            engine.params, cfg,
            torch.tensor([[served[0]]], dtype=torch.int32, device=dev),
            torch.tensor([[P]], dtype=torch.int32, device=dev), cache,
            kv_limit=engine._S_alloc if not engine.kv_pool else None,
            attn_impl=engine._decode_impl, page_size=page, **kw)
        return first[0, 0].float(), second[0, 0].float()

    names = ("flash_attention_cached", "paged_decode_attention",
             "paged_decode_attention_pool")
    plains = (flash_attention_cached_plain, paged_decode_attention_plain,
              paged_decode_attention_pool_plain)

    def exact(plain):
        """The plain version on f32 copies of q/k/v, rounded to bf16 once
        at its output: attention without bf16 probabilities."""
        def fn(q, k, v, *args, **kw):
            return plain(q.float(), k.float(), v.float(), *args,
                         **kw).to(q.dtype)
        return fn

    def run_with(fns):
        saved = [getattr(transformer, n) for n in names]
        for n, fn in zip(names, fns):
            setattr(transformer, n, fn)
        try:
            return run()
        finally:
            for n, fn in zip(names, saved):
                setattr(transformer, n, fn)

    def last_key_dropped(plain):
        def fn(q, k, v, positions, *args, **kw):
            return plain(q, k, v, positions - 1, *args, **kw)
        return fn

    def next_kv_head(plain):
        def fn(q, k, v, *args, **kw):
            return plain(q, k.roll(1, dims=2), v.roll(1, dims=2), *args,
                         **kw)
        return fn

    with torch.no_grad():
        kernel = run()
        plain = run_with(plains)
        floor = run_with([exact(fn) for fn in plains])
        wrong = {label: run_with([plains[0]] + [bad(fn) for fn in plains[1:]])
                 for label, bad in (("last_key_dropped", last_key_dropped),
                                    ("next_kv_head", next_kv_head))}
    out = {"prompt_tokens": P}
    for i, (step, tok) in enumerate(zip(("prefill", "decode"), served)):
        k_logits, p_logits = kernel[i], plain[i]
        rms = float(p_logits.pow(2).mean().sqrt())
        err = float((k_logits - p_logits).abs().max())
        rms_err = float((k_logits - p_logits).pow(2).mean().sqrt())
        floor_err = float((p_logits - floor[i]).abs().max())
        tol = max(LOGIT_RTOL * rms, FLOOR_FACTOR * floor_err)
        if step == "decode":
            caught = {}
            for label, logits in wrong.items():
                d = logits[i] - p_logits
                w_err = float(d.abs().max())
                w_rms = float(d.pow(2).mean().sqrt())
                caught[label] = {"max_abs_err": w_err, "rms_err": w_rms}
                log(f"[{tag}] decode with a wrong paged stand-in "
                    f"({label}): max |wrong - plain| {w_err:.4f}, rms "
                    f"{w_rms:.4f} (tolerances {tol:.4f}, "
                    f"{LOGIT_RTOL * rms:.4f})")
                if w_err <= tol and w_rms <= LOGIT_RTOL * rms:
                    raise AssertionError(
                        f"{tag}: the logits gate passes a wrong paged "
                        f"kernel ({label}): {w_err} <= {tol}, {w_rms} <= "
                        f"{LOGIT_RTOL * rms}")
            out["wrong_stand_ins"] = caught
        gap = float(k_logits.max()) - float(k_logits[tok])
        log(f"[{tag}] {step} logits over {P} prompt tokens: max |kernel - "
            f"plain| {err:.4f}, rms {rms_err:.4f} (logits rms {rms:.3f}; "
            f"max |plain - f32 attention| {floor_err:.4f}; tolerance "
            f"{tol:.4f}); served token {tok} sits {gap:.4f} below the "
            f"kernel argmax {int(k_logits.argmax())}")
        if not torch.isfinite(k_logits).all() or err > tol:
            raise AssertionError(f"{tag} {step}: served-path logits disagree "
                                 f"with the plain forward: {err} > {tol}")
        if rms_err > LOGIT_RTOL * rms:
            raise AssertionError(f"{tag} {step}: the rms of kernel - plain "
                                 f"{rms_err} exceeds {LOGIT_RTOL} of the "
                                 f"logits' rms {rms}")
        if gap > tol:
            raise AssertionError(f"{tag} {step}: served token {tok} is {gap} "
                                 f"below the argmax (tolerance {tol})")
        out[step] = {"max_abs_err": err, "rms_err": rms_err, "rms": rms,
                     "floor_max_abs_err": floor_err, "tolerance": tol,
                     "served_gap": gap}
    return out


# An HF-layout Gemma-2B checkpoint written by this script (the JAX
# package's tools/gen_fake_checkpoint.py imports JAX), served from
# MODEL_PATH in phase 6. The rate limit and the response cache keep
# their defaults there; the server takes a key.
CKPT_MODEL = "gemma-2b-it"
CKPT_KEY = "smoke-key"
CKPT_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": CKPT_MODEL, "DTYPE": "bfloat16",
    "DECODE_BATCH_SIZE": str(N_SLOTS),
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    "API_AUTH_KEY": CKPT_KEY,
}
# The bf16 tree is about 5.0 GB on disk; a margin on top.
CKPT_FREE_BYTES = 6_000_000_000
# Embedding rows held against the bytes written (first, middle, last).
CKPT_EMBED_ROWS = (0, 1, 128_000, 255_999)
# Requests of the default RATE_LIMIT=10/minute before the 429.
CKPT_RATE_LIMIT = 10


def write_hf_checkpoint(torch, cfg, path: Path, seed: int = 0):
    """Write ``cfg``'s weights in the HF safetensors layout under
    ``path``: ``model.embed_tokens.weight`` and ``model.norm.weight`` in
    one shard, each layer's norms and ``[out, in]`` projections in one
    shard of its own. bf16 values drawn on the card from ``seed`` at
    ``init_params``'s scales (norm weights zero: Gemma's (1 + w) norm).
    Returns (the kept tensors the loaded tree is held against, the
    bytes written)."""
    from safetensors.torch import save_file

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, H, KV, hd, F_ = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_hidden)

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def zeros(n):
        return torch.zeros(n, dtype=torch.bfloat16, device="cuda")

    kept, nbytes = {}, 0

    def save(shard: dict, name: str) -> None:
        nonlocal nbytes
        save_file({k: v.cpu() for k, v in shard.items()}, str(path / name))
        nbytes += sum(v.numel() * v.element_size() for v in shard.values())

    embed = draw((cfg.vocab_size, d), 1.0)
    kept["embed_rows"] = embed[list(CKPT_EMBED_ROWS)].clone()
    save({"model.embed_tokens.weight": embed, "model.norm.weight": zeros(d)},
         "model-embed.safetensors")
    del embed
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shard = {
            p + "input_layernorm.weight": zeros(d),
            p + "post_attention_layernorm.weight": zeros(d),
            p + "self_attn.q_proj.weight": draw((H * hd, d), d ** -0.5),
            p + "self_attn.k_proj.weight": draw((KV * hd, d), d ** -0.5),
            p + "self_attn.v_proj.weight": draw((KV * hd, d), d ** -0.5),
            p + "self_attn.o_proj.weight": draw((d, H * hd),
                                                (H * hd) ** -0.5),
            p + "mlp.gate_proj.weight": draw((F_, d), d ** -0.5),
            p + "mlp.up_proj.weight": draw((F_, d), d ** -0.5),
            p + "mlp.down_proj.weight": draw((d, F_), F_ ** -0.5),
        }
        if i in (0, cfg.n_layers - 1):
            kept[f"q_proj_{i}"] = shard[p + "self_attn.q_proj.weight"].clone()
        save(shard, f"model-layer-{i:02d}.safetensors")
    return kept, nbytes


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _timed_load(torch, engine, ckpt_bytes: int, tag: str) -> dict:
    """The engine's weight load on its own (the server's startup then
    finds the tree loaded): seconds, GB/s of checkpoint read, and the
    peak device memory it added."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine._load()
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    out = {"load_s": load_s, "load_gb_per_s": ckpt_bytes / load_s / 1e9,
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "tree_gb": _tree_bytes(engine.params) / 1e9}
    log(f"[{tag}] loaded {ckpt_bytes / 1e9:.3f} GB of checkpoint in "
        f"{load_s:.2f} s ({out['load_gb_per_s']:.2f} GB/s); tree "
        f"{out['tree_gb']:.3f} GB, load peak {out['peak_gb']:.3f} GB")
    return out


def phase_serve_ckpt(torch, serve_info: dict) -> dict:
    return asyncio.run(_serve_ckpt(torch, serve_info))


async def _serve_ckpt(torch, serve_info: dict) -> dict:
    import shutil
    import tempfile

    from ai_agent_kubectl_tpu_torch.models.config import get_config

    cfg = get_config(CKPT_MODEL)
    path = Path(tempfile.mkdtemp(prefix="smoke-gemma-2b-"))
    try:
        free = shutil.disk_usage(path).free
        log(f"[serve_ckpt] {free / 1e9:.1f} GB free under {path.parent}")
        if free < CKPT_FREE_BYTES:
            raise AssertionError(f"the checkpoint needs "
                                 f"{CKPT_FREE_BYTES / 1e9:.1f} GB free "
                                 f"under {path.parent}, {free / 1e9:.1f} GB "
                                 f"are")
        t0 = time.monotonic()
        kept, ckpt_bytes = write_hf_checkpoint(torch, cfg, path)
        write_s = time.monotonic() - t0
        log(f"[serve_ckpt] wrote {cfg.name} ({ckpt_bytes / 1e9:.3f} GB, "
            f"{cfg.n_layers + 1} shards) in {write_s:.1f} s")
        bf16, params = await _serve_ckpt_bf16(torch, path, kept,
                                              ckpt_bytes, serve_info)
        int4 = await _serve_ckpt_int4(torch, path, ckpt_bytes, params)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"checkpoint_gb": ckpt_bytes / 1e9, "write_s": write_s,
            "bf16": bf16, "int4": int4}


def _check_loaded_bytes(torch, params, kept) -> None:
    """Loaded leaves against the bytes written: embedding rows as is,
    q_proj [out, in] as wq [in, out]."""
    rows = params["embed"][list(CKPT_EMBED_ROWS)]
    if not torch.equal(rows, kept["embed_rows"]):
        raise AssertionError("loaded embedding rows differ from the file")
    wq = params["layers"]["wq"]
    for key, w in kept.items():
        if key.startswith("q_proj_"):
            layer = int(key.rsplit("_", 1)[1])
            if not torch.equal(wq[layer], w.T):
                raise AssertionError(f"loaded wq of layer {layer} is not "
                                     f"the transposed q_proj written")


async def _serve_ckpt_bf16(torch, path, kept, ckpt_bytes, serve_info):
    import aiohttp
    from aiohttp import web
    from prometheus_client.parser import text_string_to_metric_families

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.models.convert import checkpoint_version
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = "serve_ckpt/bf16"
    port = _free_port()
    _phase_env({**CKPT_ENV, "MODEL_PATH": str(path)}, port)
    cfg = ServiceConfig.from_env()
    if (cfg.rate_limit_count, cfg.rate_limit_window) != (
            CKPT_RATE_LIMIT, 60.0) or not cfg.auth_enabled:
        raise AssertionError(f"{tag}: expected the default rate limit and "
                             f"a key, got {cfg.rate_limit}")
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    load = _timed_load(torch, inner, ckpt_bytes, tag)
    _check_loaded_bytes(torch, inner.params, kept)
    if inner.weights_version != checkpoint_version(path):
        raise AssertionError(f"{tag}: weights version "
                             f"{inner.weights_version!r}")
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    log(f"[{tag}] up on {cfg.host}:{port} in {startup_s:.1f} s after the "
        f"load ({inner.device}, {inner.batch_size} slots, version "
        f"{inner.weights_version})")
    url = f"http://{cfg.host}:{port}"
    keyed = {"X-API-Key": CKPT_KEY}
    sent = {}                            # (route, status) -> count

    def count(route, status):
        sent[(route, str(status))] = sent.get((route, str(status)), 0) + 1

    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                count("/health", r.status)
                if r.status != 200 or health["breaker"] != "closed":
                    raise AssertionError(f"/health: {r.status} {health}")

            async def ask(query, headers):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query},
                                     headers=headers) as r:
                    count("/kubectl-command", r.status)
                    return r.status, await r.json(), dict(r.headers)

            engine.results.clear()
            ragged_attention_pool.launches = 0
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q, keyed) for q in QUERIES])
            burst_s = time.monotonic() - t_burst
            calls0 = engine.calls
            async with http.post(f"{url}/kubectl-command/stream",
                                 json={"query": QUERIES[0]},
                                 headers=keyed) as r:
                count("/kubectl-command/stream", r.status)
                stream_status, sse = r.status, await r.text()
            launches = ragged_attention_pool.launches
            steps = inner.forward_steps - steps0
            stream_calls = engine.calls - calls0
            unkeyed = await ask(QUERIES[1], {})
            limited = await ask(QUERIES[2], keyed)
            async with http.get(f"{url}/metrics") as r:
                metrics_status, metrics = r.status, await r.text()
            async with http.get(f"{url}/openapi.json") as r:
                openapi_status = r.status
                paths = sorted((await r.json())["paths"])
    finally:
        await runner.cleanup()           # drains and stops the engine

    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [st for st, _, _ in burst]
    for query, (status, body, _) in zip(QUERIES, burst):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{tag} {query!r}: no tokens generated")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{tag} {query!r}: HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}: "
                                 f"{body}")
    events = re.findall(r"^event: (\w+)$", sse, re.M)
    first = results[render_prompt(QUERIES[0])][0]
    want_event = "done" if status_for_text(first.text) == 200 else "error"
    if stream_status != 200 or not events or events[-1] != want_event:
        raise AssertionError(f"{tag}: the stream answered {stream_status} "
                             f"with events {events}, want ... {want_event}")
    if want_event == "error" and stream_calls != 1:
        raise AssertionError(f"{tag}: the stream repeat of an uncached 422 "
                             f"made {stream_calls} engine calls, want 1")
    if unkeyed[0] != 401 or unkeyed[1] != {
            "detail": "Missing X-API-Key header"}:
        raise AssertionError(f"{tag}: no key gave {unkeyed[:2]}")
    if limited[0] != 429 or "Retry-After" not in limited[2]:
        raise AssertionError(f"{tag}: the request after {CKPT_RATE_LIMIT} "
                             f"gave {limited[0]} {limited[1]} "
                             f"{limited[2].get('Retry-After')}")
    if metrics_status != 200:
        raise AssertionError(f"{tag}: /metrics answered {metrics_status}")
    served = {}
    for fam in text_string_to_metric_families(metrics):
        if fam.name == "http_requests":
            for smp in fam.samples:
                if smp.name == "http_requests_total":
                    served[(smp.labels["handler"], smp.labels["status"])] = \
                        int(smp.value)
    if served != sent:
        raise AssertionError(f"{tag}: http_requests_total {served} != the "
                             f"requests sent {sent}")
    if openapi_status != 200 or "/kubectl-command/stream" not in paths:
        raise AssertionError(f"{tag}: /openapi.json {openapi_status} "
                             f"{paths}")
    n_layers = inner.model_cfg.n_layers
    if steps <= 0 or launches < n_layers * steps:
        raise AssertionError(f"{tag}: ragged kernel launched {launches} "
                             f"times for {steps} forward steps x "
                             f"{n_layers} layers")
    check_pool_books(inner)
    logit_check = _check_served_logits(torch, inner, results, tag)
    firsts = [results[render_prompt(q)][0] for q in QUERIES]
    n_tok = sum(r.completion_tokens for r in firsts)
    info = {
        **load, "startup_s": startup_s, "launches": launches,
        "forward_steps": steps, "statuses": statuses,
        "stream_events": events[-1], "stream_engine_calls": stream_calls,
        "unkeyed_status": unkeyed[0], "limited_status": limited[0],
        "retry_after": limited[2].get("Retry-After"),
        "http_requests_total": {f"{k[0]} {k[1]}": v
                                for k, v in sorted(served.items())},
        "burst_s": burst_s, "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s,
        "serve_burst_tok_per_s": serve_info.get("burst_tok_per_s"),
        "logits": logit_check,
    }
    log(f"[{tag}] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} s "
        f"({info['burst_tok_per_s']:.1f} tok/s; the serve phase, same model "
        f"and traffic from random weights in memory: "
        f"{info['serve_burst_tok_per_s']} tok/s); stream ended "
        f"'{events[-1]}' after {stream_calls} engine call(s); no key "
        f"{unkeyed[0]}, request {CKPT_RATE_LIMIT + 1} {limited[0]} "
        f"(Retry-After {info['retry_after']}); http_requests_total "
        f"{info['http_requests_total']}; ragged launches {launches} over "
        f"{steps} forward steps")
    return info, inner.params


async def _serve_ckpt_int4(torch, path, ckpt_bytes, bf16_params):
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.quant import quantize_embed_int8
    from ai_agent_kubectl_tpu_torch.ops.quant4 import (QuantInt4,
                                                       quantize_int4,
                                                       qmatmul4)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine

    tag = "serve_ckpt/int4"
    port = _free_port()
    _phase_env({**CKPT_ENV, "MODEL_PATH": str(path), "QUANT": "int4",
                "DECODE_BATCH_SIZE": "1"}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if type(inner) is not TorchEngine:
        raise AssertionError(f"engine construction failed: {inner!r}")
    load = _timed_load(torch, inner, ckpt_bytes, tag)
    mc = inner.model_cfg
    d, F_ = mc.dim, mc.mlp_hidden
    qd, kvd = mc.n_heads * mc.head_dim, mc.n_kv_heads * mc.head_dim
    layer_bf16 = 2 * d * (2 * qd + 2 * kvd + 3 * F_)
    embed_bf16 = 2 * mc.vocab_size * d
    bound = load["tree_gb"] * 1e9 + embed_bf16 + 2 * layer_bf16
    load["peak_bound_gb"] = bound / 1e9
    log(f"[{tag}] load peak {load['peak_gb']:.3f} GB against the bound "
        f"{bound / 1e9:.3f} GB (quantized tree {load['tree_gb']:.3f} + bf16 "
        f"embedding {embed_bf16 / 1e9:.3f} + two layers' bf16 slices "
        f"{2 * layer_bf16 / 1e9:.3f}); the bf16 tree is "
        f"{ckpt_bytes / 1e9:.3f} GB")
    if load["peak_gb"] * 1e9 > bound:
        raise AssertionError(f"{tag}: the int4 load peaked at "
                             f"{load['peak_gb']:.3f} GB, over the bound")
    # Every quantized leaf against quantize_int4 of the bf16 leaf, one
    # layer at a time; the embedding against quantize_embed_int8.
    checked = 0
    for key, leaf in inner.params["layers"].items():
        if not isinstance(leaf, QuantInt4):
            if key.endswith("norm") and torch.equal(
                    leaf, bf16_params["layers"][key]):
                continue
            raise AssertionError(f"{tag}: {key} is {type(leaf).__name__}")
        for i in range(mc.n_layers):
            want = quantize_int4(bf16_params["layers"][key][i],
                                 group_in=leaf.group_in,
                                 block_out=leaf.block_out)
            if not (torch.equal(leaf.q[i], want.q)
                    and torch.equal(leaf.scale[i], want.scale)):
                raise AssertionError(f"{tag}: {key}[{i}] differs from "
                                     f"quantize_int4 of the bf16 leaf")
            checked += 1
    emb = inner.params["embed"]
    for r0 in range(0, mc.vocab_size, 32768):
        want = quantize_embed_int8(bf16_params["embed"][r0:r0 + 32768])
        if not (torch.equal(emb.q[r0:r0 + 32768], want.q)
                and torch.equal(emb.scale[r0:r0 + 32768], want.scale)):
            raise AssertionError(f"{tag}: embedding rows {r0}.. differ from "
                                 f"quantize_embed_int8")
    log(f"[{tag}] {checked} int4 layer slices and the per-row int8 "
        f"embedding bit-equal to quantizing the bf16 load")
    runner = web.AppRunner(create_app(cfg, inner), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    try:
        async with aiohttp.ClientSession() as http:
            flash_attention_cached.launches = 0
            qmatmul4.launches = 0
            async with http.post(f"http://{cfg.host}:{port}/kubectl-command",
                                 json={"query": QUERIES[0]},
                                 headers={"X-API-Key": CKPT_KEY}) as r:
                status, body = r.status, await r.json()
            launches = {"flash_attention": flash_attention_cached.launches,
                        "int4_matmul": qmatmul4.launches}
    finally:
        await runner.cleanup()
    if status not in (200, 422):
        raise AssertionError(f"{tag}: HTTP {status} {body}")
    if (launches["flash_attention"] < mc.n_layers
            or launches["int4_matmul"] < 7 * mc.n_layers):
        raise AssertionError(f"{tag}: kernel launches {launches}")
    log(f"[{tag}] one request: HTTP {status}; launches {launches}")
    return {**load, "status": status, "launches": launches,
            "int4_slices_checked": checked}


# ------------------------------------------------------------ serve_qos

#: The QoS ring's knobs of phase 7, on top of the serve phase's config:
#: two registered tenants (bulk-key may run background only, hi-key
#: interactive), preemption after 50 ms of starvation, four queued
#: requests per tenant at most.
QOS_ENV = {
    **SERVE_ENV,
    "TENANT_TIERS": "bulk-key:background,hi-key:interactive",
    "PREEMPT_WAIT_MS": "50", "TENANT_MAX_QUEUE": "4",
    # Above serve's 128: when a filler wave is seated over two chunks its
    # first filler leads by up to 112 tokens as the interactive requests
    # arrive at pipe depth 1, and at the default depth of 3 each of the
    # three waits for tokens below reads them two chunks later still (up
    # to 96 more); with less it would finish and free a slot before any
    # preemption could fire.
    "MAX_NEW_TOKENS": "256",
}
QOS_BULK, QOS_HI = {"X-API-Key": "bulk-key"}, {"X-API-Key": "hi-key"}
#: the two reference requests: a greedy one over HTTP, and a sampled one
#: as a direct engine call (HTTP carries no temperature or seed)
QOS_GREEDY = "list all pods in the default namespace"
QOS_SAMPLED = ("show the nodes with their labels", 0.9, 4242)
QOS_INTERACTIVE = ["get pods in kube-system now",
                   "describe the service named api"]
#: tokens every slot holds before the interactive requests arrive
QOS_MIN_TOKENS = 32


def phase_serve_qos(torch) -> dict:
    return asyncio.run(_serve_qos(torch))


async def _serve_qos(torch) -> dict:
    a, params = await _serve_qos_one(torch, "pool", {}, None, 8)
    b, _ = await _serve_qos_one(
        torch, "dense", {"KV_POOL": "false", "DECODE_ATTN": "paged"}, params,
        2)
    return {"pool": a, "dense": b}


async def _wait_slots(inner, n_busy: int, min_tokens: int,
                      timeout: float = 120.0) -> None:
    """Until ``n_busy`` slots are seated with ``min_tokens`` each."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        busy = [s for s in inner._slots if s is not None]
        if (len(busy) >= n_busy
                and all(len(s.detok.ids) >= min_tokens for s in busy)):
            return
        await asyncio.sleep(0.002)
    held = [None if s is None else len(s.detok.ids) for s in inner._slots]
    raise AssertionError(f"{n_busy} slots never held {min_tokens} tokens "
                         f"each: {held}")


def _first_mismatch(torch, engine, prompt_ids, want, got, temperature,
                    seed, allowed=None):
    """Where a resumed transcript first leaves its uncontended one, and
    how near a tie the uncontended pick was there: the gap between the
    two highest scores (logits, or logits / T plus the gumbel noise of
    the (seed, index) key, times T; under a grammar, ``allowed`` [V] bool
    drops the illegal ones) of the forward over prompt + the common
    prefix, against LOGIT_RTOL x the logits' rms. None when the two are
    equal."""
    from ai_agent_kubectl_tpu_torch.engine.sampling import gumbel, slot_keys
    from ai_agent_kubectl_tpu_torch.models import transformer

    want, got = list(want), list(got)
    if want == got:
        return None
    k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    ids = list(prompt_ids) + want[:k]
    P = len(ids)
    pages = -(-P // PAGE)
    dev = engine.device
    with torch.no_grad():
        cache = transformer.KVCache.pool(engine.model_cfg, pages, PAGE,
                                         dtype=engine.dtype, device=dev)
        logits, _ = transformer.forward(
            engine.params, engine.model_cfg, torch.tensor([ids], device=dev),
            torch.arange(P, dtype=torch.int32, device=dev)[None], cache,
            block_tables=torch.arange(pages, dtype=torch.int32,
                                      device=dev)[None],
            logits_at=torch.tensor([P - 1], device=dev))
    logits = logits[0, 0].float()
    rms = float(logits.pow(2).mean().sqrt())
    scores, scale = logits, 1.0
    if temperature > 0:
        keys = slot_keys(torch.tensor([seed], device=dev),
                         torch.tensor([k], device=dev))
        scores = logits / temperature + gumbel(keys, logits.shape[-1])[0]
        scale = temperature
    if allowed is not None:
        scores = scores.masked_fill(~torch.from_numpy(allowed).to(dev),
                                    float("-inf"))
    top2 = torch.topk(scores, 2).values
    return {"position": k, "gap": float(top2[0] - top2[1]) * scale,
            "tolerance": LOGIT_RTOL * rms}


async def _serve_qos_one(torch, kind: str, env: dict, params, slots: int):
    """One engine of phase 7 over HTTP: the two references uncontended,
    then the slots filled with background work, interactive arrivals
    that must preempt, and (in the pool) a flood of the background
    tenant up to its queue cap."""
    import aiohttp
    from aiohttp import web
    from prometheus_client.parser import text_string_to_metric_families

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.qos import QoSContext, use_qos
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_qos/{kind}"
    port = _free_port()
    _phase_env({**QOS_ENV, **env, "DECODE_BATCH_SIZE": str(slots)}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    if params is not None:
        inner.params = params
    engine = RecordingEngine(inner)
    # Seams the gates read: each resume's radix match (pool), each
    # resume's flash launches (dense), the victims, chunk dispatch times.
    remaps, resume_flash, victims, dispatch_t = [], [], [], []
    map_prefix, replay = inner._pool_map_prefix, inner._replay_slot
    preempt, dispatch = inner._preempt_slot, inner._dispatch_chunk

    def on_map(ids, match_all=False):
        blocks, m = map_prefix(ids, match_all=match_all)
        if match_all:
            remaps.append((len(ids), m))
        return blocks, m

    def on_replay(slot):
        n0 = flash_attention_cached.launches
        replay(slot)
        resume_flash.append(flash_attention_cached.launches - n0)

    def on_preempt(idx, for_lane):
        slot = inner._slots[idx]
        victims.append((list(slot.req.prompt_ids), slot.req.temperature,
                        slot.req.seed, len(slot.detok.ids)))
        preempt(idx, for_lane)

    def on_dispatch():
        dispatch_t.append((time.monotonic(),
                           any(t > 0.0 for t in inner._temps),
                           sum(s is not None for s in inner._slots)))
        dispatch()

    inner._pool_map_prefix, inner._replay_slot = on_map, on_replay
    inner._preempt_slot, inner._dispatch_chunk = on_preempt, on_dispatch
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    log(f"[{tag}] {cfg.model_name} up on {cfg.host}:{port} in "
        f"{startup_s:.1f} s ({inner.batch_size} slots, regime "
        f"{inner._attention_regime}, decode {inner._decode_impl})")
    url = f"http://{cfg.host}:{port}"
    prompt_s = render_prompt(QOS_SAMPLED[0])
    key_g = tuple(inner.tokenizer.encode(render_prompt(QOS_GREEDY)))
    key_s = tuple(inner.tokenizer.encode(prompt_s))
    fillers = [q for q in QUERIES if q not in (QOS_GREEDY, QOS_SAMPLED[0])]
    fillers = fillers[:slots - 2]
    counters = (ragged_attention_pool, flash_attention_cached,
                paged_decode_attention, paged_decode_attention_pool)
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query, headers):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query},
                                     headers=headers) as r:
                    return r.status, await r.json(), dict(r.headers)

            async def sampled():
                with use_qos(QoSContext(tenant="bulk-key",
                                        lane="background")):
                    return await inner.generate(
                        prompt_s, max_tokens=cfg.max_new_tokens,
                        temperature=QOS_SAMPLED[1], seed=QOS_SAMPLED[2])

            for fn in counters:
                fn.launches = 0
            engine.results.clear()
            # Uncontended, one at a time: the references.
            ref_greedy = await ask(QOS_GREEDY, QOS_BULK)
            ref_sampled = await sampled()
            ref_ids = {key_g: engine.results[0][1].token_ids,
                       key_s: ref_sampled.token_ids}
            # The fillers (at most four at a time: the tenant's cap),
            # then the two references again, last, so they hold the
            # fewest tokens when the interactive requests arrive.
            t_burst = time.monotonic()
            tasks = []
            for i in range(0, len(fillers), 4):
                wave = fillers[i:i + 4]
                tasks += [asyncio.ensure_future(ask(q, QOS_BULK))
                          for q in wave]
                await _wait_slots(inner, i + len(wave), 1)
            tasks.append(asyncio.ensure_future(ask(QOS_GREEDY, QOS_BULK)))
            sampled_task = asyncio.ensure_future(sampled())
            await _wait_slots(inner, slots, QOS_MIN_TOKENS)
            n_chunks0 = len(dispatch_t)
            held_at_hi = [None if s is None else len(s.detok.ids)
                          for s in inner._slots]
            hi_tasks = [asyncio.ensure_future(ask(q, QOS_HI))
                        for q in QOS_INTERACTIVE[:1 if kind == "dense"
                                                 else 2]]
            # The background tenant floods until one request finds four
            # of its own queued (requeued victims count).
            flood, shed = [], None
            if kind == "pool":
                t_wait = time.monotonic()
                while (inner._preemptions < len(hi_tasks)
                       and time.monotonic() - t_wait < 30.0):
                    await asyncio.sleep(0.005)
                for i in range(12):
                    flood.append(asyncio.ensure_future(
                        ask(f"list the pods of job {i}", QOS_BULK)))
                    await asyncio.sleep(0.05)
                    done = [t for t in flood if t.done()
                            and t.result()[0] == 429]
                    if done:
                        shed = done[0].result()
                        break
            hi = await asyncio.gather(*hi_tasks)
            bg = await asyncio.gather(*tasks)
            res_sampled = await sampled_task
            burst_s = time.monotonic() - t_burst
            flooded = await asyncio.gather(*flood)
            launches = {fn.__name__: fn.launches for fn in counters}
            async with http.get(f"{url}/health") as r:
                health = await r.json()
            async with http.get(f"{url}/metrics") as r:
                metrics = await r.text()
            stats = inner.stats()
    finally:
        await runner.cleanup()           # drains and stops the engine

    qos = stats["qos"]
    scraped = {}
    for fam in text_string_to_metric_families(metrics):
        for smp in fam.samples:
            if smp.name == "qos_preemptions_total":
                scraped["preemptions"] = int(smp.value)
    n_hi = len(hi_tasks)
    if qos["preemptions"] < 1 or scraped.get("preemptions") != \
            qos["preemptions"]:
        raise AssertionError(
            f"{tag}: preemptions {qos['preemptions']}, "
            f"qos_preemptions_total {scraped}; tokens a slot held when "
            f"the interactive requests were sent {held_at_hi}, busy slots "
            f"at each chunk after {[n for *_, n in dispatch_t[n_chunks0:]]}"
            f", qos {qos}")
    if not health.get("qos") or "lanes" not in health["qos"]:
        raise AssertionError(f"{tag}: /health has no qos section: {health}")
    # Statuses: the service's decision for every request it served, the
    # tenant cap's 429 for the shed one.
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    served = [(QOS_GREEDY, 0, ref_greedy)] + [
        (q, 0 if q != QOS_GREEDY else 1, a) for q, a in zip(
            fillers + [QOS_GREEDY] + QOS_INTERACTIVE[:n_hi]
            + [f"list the pods of job {i}" for i in range(len(flood))],
            bg + hi + flooded)]
    statuses = []
    for query, k, (status, body, _) in served:
        statuses.append(status)
        if shed is not None and (status, body) == shed[:2]:
            continue                     # the tenant cap's 429
        res = results[render_prompt(query)][k]
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{tag} {query!r}: HTTP {status}, the "
                                 f"service gives {want}: {body}")
    if kind == "pool":
        if shed is None or "(4/4 queued for tenant 'bulk-key'" not in \
                shed[1]["detail"]:
            raise AssertionError(f"{tag}: no request was shed at the "
                                 f"tenant cap: {[s for s, *_ in flooded]}")
        if float(shed[2].get("Retry-After", 0)) < 1:
            raise AssertionError(f"{tag}: 429 without Retry-After >= 1: "
                                 f"{shed[2]}")
        if any(n - m > PAGE for n, m in remaps) or not remaps:
            raise AssertionError(f"{tag}: a resume prefilled more than a "
                                 f"page: {remaps}")
        check_pool_books(inner)
    elif not resume_flash or min(resume_flash) < inner.model_cfg.n_layers:
        raise AssertionError(f"{tag}: a resume did not prefill through "
                             f"flash: {resume_flash}")
    # Seat time: PREEMPT_WAIT_MS plus two decode chunks, a chunk being
    # the median dispatch-to-dispatch time of the last four chunks before
    # the interactive requests arrived (every slot busy).
    def median_chunk_ms(pairs):
        gaps = sorted(c1[0] - c0[0] for c0, c1 in pairs)
        return gaps[len(gaps) // 2] * 1e3 if gaps else None

    recent = dispatch_t[max(0, n_chunks0 - 5):n_chunks0]
    chunk_ms = median_chunk_ms(zip(recent, recent[1:]))
    # What a sampled row costs a chunk: the median dispatch-to-dispatch
    # time of chunks with every row greedy and of chunks with a sampled
    # row aboard, by busy slots (the references ran alone: one slot).
    chunk_cost = {}
    for c0, c1 in zip(dispatch_t, dispatch_t[1:]):
        if c0[1:] == c1[1:]:
            key = f"{'sampled' if c0[1] else 'greedy'}@{c0[2]}"
            chunk_cost.setdefault(key, []).append((c0, c1))
    chunk_cost = {k: {"chunks": len(v), "chunk_ms": median_chunk_ms(v)}
                  for k, v in sorted(chunk_cost.items())}
    seat_limit = float(QOS_ENV["PREEMPT_WAIT_MS"]) + 2 * chunk_ms
    hi_res = [results[render_prompt(q)][-1] for q in QOS_INTERACTIVE[:n_hi]]
    for q, r in zip(QOS_INTERACTIVE, hi_res):
        if r.queue_ms > seat_limit:
            raise AssertionError(f"{tag} {q!r}: seated after "
                                 f"{r.queue_ms:.1f} ms, limit "
                                 f"{seat_limit:.1f} ms")
    # Every victim's transcript against its uncontended one.
    got_ids = {key_g: results[render_prompt(QOS_GREEDY)][1].token_ids,
               key_s: res_sampled.token_ids}
    checked = []
    for prompt_ids, temp, seed, at in victims:
        key = tuple(prompt_ids)
        if key not in ref_ids:
            raise AssertionError(f"{tag}: a victim without a reference "
                                 f"({len(key)} prompt tokens, {at} "
                                 f"generated)")
        miss = _first_mismatch(torch, inner, prompt_ids, ref_ids[key],
                               got_ids[key], temp, seed)
        checked.append({"temperature": temp, "preempted_at": at,
                        "mismatch": miss})
        log(f"[{tag}] victim (temperature {temp}) preempted after {at} "
            f"tokens: " + ("transcript equal to its uncontended one"
                           if miss is None else
                           f"first mismatch at token {miss['position']}, "
                           f"top-2 gap {miss['gap']:.4f} (tolerance "
                           f"{miss['tolerance']:.4f})"))
        if miss is not None and miss["gap"] > miss["tolerance"]:
            raise AssertionError(f"{tag}: a resumed transcript left its "
                                 f"uncontended one away from a near tie: "
                                 f"{miss}")
    n_tok = sum(r.completion_tokens for r in
                [results[render_prompt(q)][0] for q in fillers]
                + [results[render_prompt(QOS_GREEDY)][1], res_sampled])
    info = {
        "slots": slots, "startup_s": startup_s, "statuses": statuses,
        "preemptions": qos["preemptions"],
        "preempted_tokens": qos["preempted_tokens"],
        "victims": checked, "resume_remaps": remaps,
        "resume_flash_launches": resume_flash,
        "chunk_ms": chunk_ms, "seat_limit_ms": seat_limit,
        "chunk_cost": chunk_cost,
        "interactive": [{"queue_ms": r.queue_ms, "ttft_ms": r.ttft_ms}
                        for r in hi_res],
        "burst_s": burst_s, "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s, "launches": launches,
        "shed": None if shed is None else {
            "status": shed[0], "retry_after": shed[2].get("Retry-After"),
            "flood_sent": len(flood)},
        "health_qos": health["qos"],
    }
    log(f"[{tag}] burst of {slots} background requests: {n_tok} tokens in "
        f"{burst_s:.2f} s ({info['burst_tok_per_s']:.1f} tok/s, the "
        f"preemptions and resumes included); chunk {chunk_ms:.1f} ms; "
        f"median chunk by batch: {chunk_cost}")
    for q, r in zip(QOS_INTERACTIVE, hi_res):
        log(f"[{tag}] interactive {q!r}: queue {r.queue_ms:.1f} ms (limit "
            f"{seat_limit:.1f}), TTFT {r.ttft_ms:.1f} ms")
    log(f"[{tag}] preemptions {qos['preemptions']} "
        f"({qos['preempted_tokens']} tokens carried); resumes "
        f"{remaps if kind == 'pool' else resume_flash} "
        f"({'(tokens, radix-matched)' if kind == 'pool' else 'flash launches'}"
        f"); statuses {statuses}"
        + (f"; shed {shed[0]} with Retry-After {shed[2].get('Retry-After')}"
           f" after {len(flood)} flood requests" if shed else ""))
    log(f"[{tag}] launches in the phase: ragged "
        f"{launches['ragged_attention_pool']}, flash "
        f"{launches['flash_attention_cached']}, paged "
        f"{launches['paged_decode_attention']} (dense) + "
        f"{launches['paged_decode_attention_pool']} (pool); {gpu_line()}")
    if kind == "pool":
        info["sampling"] = _sampling_step(torch, inner)
    return info, inner.params


def _sampling_step(torch, engine) -> dict:
    """One sampled decode step's sampler at the engine's shape (8 rows
    over Gemma's vocabulary, temperature 0.9 in every row): the kernels
    it launches (``torch.profiler``) and its time, beside the greedy
    argmax's."""
    from torch.profiler import ProfilerActivity, profile

    from ai_agent_kubectl_tpu_torch.engine.sampling import (
        greedy_tokens, sample_tokens_seeded)

    dev = engine.device
    n, vocab = engine.batch_size, engine.model_cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((n, vocab), generator=gen, device=dev)
    seeds = torch.arange(n, dtype=torch.int64, device=dev) + 7
    ngen = torch.full((n,), 40, dtype=torch.int32, device=dev)
    temps = torch.full((n,), 0.9, dtype=torch.float32, device=dev)

    def step():
        return sample_tokens_seeded(logits, seeds, ngen, temps,
                                    top_k=engine.top_k, top_p=engine.top_p)

    def per_call_ms(fn, iters=20):
        """Wall milliseconds per call, launches included (the sampler is
        host-bound): CUDA events around ``iters`` calls in a row."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = sum(int(e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    sampled_ms = per_call_ms(step)
    greedy_ms = per_call_ms(lambda: greedy_tokens(logits))
    log(f"[serve_qos] sampled step ({n} x {vocab}, top_k {engine.top_k}): "
        f"{launches} kernel launches, {sampled_ms:.4f} ms a call; greedy "
        f"argmax {greedy_ms:.4f} ms")
    return {"kernel_launches": launches, "ms": sampled_ms,
            "greedy_ms": greedy_ms}


# --------------------------------------------------------------- serve_moe

# Phase 8's configuration, as the server reads it: Mixtral-8x7B with int4
# attention and head, int8 experts, a per-row int8 embedding; every
# other knob at its default (ragged pool regime, 16-token pages and
# chunks, 128 new tokens, greedy, MOE_IMPL=auto).
MOE_MODEL = "mixtral-8x7b-instruct"
#: the layers serve_moe runs, of Mixtral's 32 (widths untouched): since
#: the pipe's default depth of 3 every serving phase dispatches two
#: chunks past each drain, and the whole script must stay well inside
#: its time limit (PHASE_LAYERS)
MOE_LAYERS = 8
SERVE_MOE_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": MOE_MODEL, "DTYPE": "bfloat16", "QUANT": "int4",
    "DECODE_BATCH_SIZE": str(N_SLOTS), "MAX_SEQ_LEN": "1024",
    "PREFILL_BUCKETS": "64,128,256,512",
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    "RATE_LIMIT": "1000/minute",
}
SERVE_MOE_ENGINES = {"pool": {}, "single": {"DECODE_BATCH_SIZE": "1"}}
# The layer whose served hidden states (the inputs of its MoE MLP in the
# pool's decode steps) the dense-mix check takes, and how many tokens.
MOE_CHECK_LAYER, MOE_CHECK_TOKENS = MOE_LAYERS - 1, 64
# Free device memory the phase asks for beyond the quantized tree: the KV
# pool (1.07 GB at MAX_SEQ_LEN 1024) and the transients of a prologue.
MOE_HEADROOM_BYTES = 4_000_000_000


def cut_config(name: str, n_layers: int):
    """The registry's config of ``name`` at ``n_layers`` layers."""
    import dataclasses

    from ai_agent_kubectl_tpu_torch.models.config import get_config

    return dataclasses.replace(get_config(name), n_layers=n_layers)


@contextlib.contextmanager
def phase_layers(phase: str):
    """The port's model registry with ``PHASE_LAYERS[phase]``'s cut
    configs in place while the phase runs, the full ones after."""
    from ai_agent_kubectl_tpu_torch.models import config as registry

    cut = PHASE_LAYERS.get(phase, {})
    kept = {name: registry.get_config(name) for name in cut}
    try:
        for name, n_layers in cut.items():
            registry._CONFIGS[name] = cut_config(name, n_layers)
            log(f"[{phase}] {name}: {n_layers} of its "
                f"{kept[name].n_layers} layers (PHASE_LAYERS)")
        yield
    finally:
        registry._CONFIGS.update(kept)


def quantized_tree_bytes(cfg) -> int:
    """Bytes of ``random_params_int8(cfg, int4=True, quantize_embed=True)``
    in bf16, from the shapes alone: packed int4 where ``pick_format``
    tiles a 2-D-per-layer projection (half a byte an element, f32 group
    scales), int8 with f32 per-channel scales elsewhere (the expert
    stacks), the per-row int8 embedding, bf16 norms and router."""
    from ai_agent_kubectl_tpu_torch.models.convert import expected_shapes
    from ai_agent_kubectl_tpu_torch.ops.quant import _QUANT_KEYS
    from ai_agent_kubectl_tpu_torch.ops.quant4 import pick_format

    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    def quantized(shape):
        IN, OUT = shape[-2:]
        fmt = pick_format(IN, OUT) if len(shape) <= 3 else None
        if fmt is not None:
            return numel(shape) // 2 + 4 * numel(shape) // fmt[0]
        return numel(shape) + 4 * numel(shape) // IN

    shapes = expected_shapes(cfg)
    total = 0
    for name, shape in shapes["layers"].items():
        total += (quantized(shape) if name in _QUANT_KEYS
                  else 2 * numel(shape))
    V, D = shapes["embed"]
    total += V * D + 4 * V + 2 * D
    if "lm_head" in shapes:
        total += quantized(shapes["lm_head"])
    return total


def moe_transient_bytes(cfg, tokens: int) -> int:
    """A bound on one MoE layer's transient at ``tokens`` tokens in one
    forward: one expert's bf16 copy of an int8 slice, the expert's
    [tokens, F] activations (gate, up, their product, the f32 epilogue
    of each product and its cast: 16 bytes an element), the layer's
    [tokens, D] streams (attention's q/k/v/out and the residual in bf16,
    the float32 mix accumulator and the weighted expert output: 32 bytes
    an element) and the routing ([tokens, E] logits, order, mix: 32
    bytes an element)."""
    D, F_, E = cfg.dim, cfg.mlp_hidden, cfg.n_experts
    return 2 * D * F_ + tokens * (16 * F_ + 32 * D + 32 * E)


def release_served_apps(torch) -> None:
    """Free what earlier serving phases left on the card. aiohttp
    memoizes each (handler, app) pair's middleware chain in a
    module-level LRU cache (``web_app._cached_build_middleware``), so
    every app a phase built keeps its service and engine (weights and
    KV) alive after the phase ends: about 46 GB by serve_moe. A server
    builds one app per process and never meets this."""
    import gc

    from aiohttp import web_app

    web_app._cached_build_middleware.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_moe(torch, profile: bool = False) -> dict:
    """Phase 8: Mixtral-8x7B at full width on one card, one parameter
    tree drawn once for (a) the pool engine and (b) the single-sequence
    engine; then the dense-mix check on (a)'s hidden states and the
    peak-memory gate. The tree is freed at the end."""
    import gc

    from ai_agent_kubectl_tpu_torch.ops.quant import random_params_int8

    release_served_apps(torch)
    cfg = cut_config(MOE_MODEL, MOE_LAYERS)
    want_tree = quantized_tree_bytes(cfg)
    free, total = torch.cuda.mem_get_info()
    log(f"[serve_moe] {cfg.name}: {cfg.n_layers} layers, dim {cfg.dim}, "
        f"{cfg.n_experts} experts of {cfg.mlp_hidden} ({cfg.experts_per_token}"
        f" routed), {cfg.n_heads} over {cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}; quantized tree {want_tree / 1e9:.3f} GB (derived "
        f"from the shapes); device memory free {free / 1e9:.3f} of "
        f"{total / 1e9:.3f} GB")
    if free < want_tree + MOE_HEADROOM_BYTES:
        raise AssertionError(
            f"serve_moe needs {(want_tree + MOE_HEADROOM_BYTES) / 1e9:.3f} "
            f"GB free on the card, {free / 1e9:.3f} GB are")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = random_params_int8(
        torch.Generator(device="cuda").manual_seed(0), cfg,
        dtype=torch.bfloat16, quantize_embed=True, int4=True, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    tree = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[serve_moe] random int4/int8 tree drawn on the card in "
        f"{init_s:.2f} s: {tree / 1e9:.3f} GB")
    if tree != want_tree:
        raise AssertionError(f"tree of {tree} bytes, the shapes give "
                             f"{want_tree}")
    out = {"init_s": init_s, "tree_bytes": tree, "free_bytes": free}
    try:
        for kind, env in SERVE_MOE_ENGINES.items():
            out[kind] = asyncio.run(_serve_moe_one(torch, kind, env, params,
                                                   profile))
            gc.collect()
        out["mix"] = _check_moe_mix(torch, cfg, params,
                                    out["pool"].pop("captured"))
        peak = torch.cuda.max_memory_allocated()
        T = N_SLOTS * max(int(b) for b in
                          SERVE_MOE_ENV["PREFILL_BUCKETS"].split(","))
        bound = (tree + out["pool"]["kv_bytes"] + out["single"]["kv_bytes"]
                 + moe_transient_bytes(cfg, T))
        out.update(peak_bytes=peak, peak_bound_bytes=bound)
        log(f"[serve_moe] peak device memory {peak / 1e9:.3f} GB, bound "
            f"{bound / 1e9:.3f} GB = tree {tree / 1e9:.3f} + pool KV "
            f"{out['pool']['kv_bytes'] / 1e9:.3f} + single-sequence KV and "
            f"prefix {out['single']['kv_bytes'] / 1e9:.3f} + one MoE "
            f"layer's transient at {T} tokens "
            f"{moe_transient_bytes(cfg, T) / 1e9:.3f}")
        if peak > bound:
            raise AssertionError(f"peak device memory {peak} over the bound "
                                 f"{bound}")
        # A decode step's bound: every weight read once (the embedding
        # but one row), against the bf16 copy of the experts that each
        # step makes and reads back (int8 read, bf16 written and read).
        V, D = cfg.vocab_size, cfg.dim
        step_bytes = tree - (V * D + 4 * V)
        convert_bytes = (3 * cfg.n_layers * cfg.n_experts * D
                         * cfg.mlp_hidden * (1 + 2 + 2))
        out.update(step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                   convert_traffic_ms=convert_bytes / HBM_BYTES_PER_S * 1e3)
        log(f"[serve_moe] a decode step: (a) {out['pool']['step_ms']:.2f} "
            f"ms (the burst's wall time per decode step), (b) "
            f"{out['single']['decode_ms_per_step']:.2f} ms; bound "
            f"{out['step_bound_ms']:.2f} ms ({step_bytes / 1e9:.2f} GB of "
            f"weights once); the experts' bf16 copy alone moves "
            f"{convert_bytes / 1e9:.1f} GB, {out['convert_traffic_ms']:.1f} "
            f"ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


async def _serve_moe_one(torch, kind: str, env: dict, params,
                         profile: bool) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.models import transformer
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.quant4 import qmatmul4
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.parallel import moe
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_moe/{kind}"
    counted = {"ragged_attention_pool": ragged_attention_pool,
               "flash_attention_cached": flash_attention_cached,
               "qmatmul4": qmatmul4,
               "paged_decode_attention_pool": paged_decode_attention_pool,
               "paged_decode_attention": paged_decode_attention}
    port = _free_port()
    _phase_env({**SERVE_MOE_ENV, **env}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    pool = kind == "pool"
    if type(inner) is not (BatchedTorchEngine if pool else TorchEngine):
        raise AssertionError(f"{tag}: engine construction failed: {inner!r}")
    inner.model_cfg = cut_config(MOE_MODEL, MOE_LAYERS)
    inner.params = params
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    mcfg = inner.model_cfg
    L = mcfg.n_layers
    log(f"[{tag}] {cfg.model_name} quant={inner.quant} up on "
        f"{cfg.host}:{port} in {startup_s:.1f} s"
        + (f" ({inner.batch_size} slots, regime {inner._attention_regime}, "
           f"pool {inner._pool_n_blocks} blocks of {inner.kv_pool_page})"
           if pool else f" (prefill {inner.attn_impl}, prefix "
           f"{inner._prefix.n} tokens)"))
    if pool and inner._attention_regime != "ragged":
        raise AssertionError(f"{tag}: regime {inner._attention_regime}")

    # The served forward's hooks: the routed experts of every decode step
    # (all layers), and the MoE inputs of MOE_CHECK_LAYER's decode steps.
    E = mcfg.n_experts
    hist = torch.zeros((E,), dtype=torch.int64, device="cuda")
    captured = []
    check_router = params["layers"]["router"][MOE_CHECK_LAYER].data_ptr()
    router_weights, dense_moe = moe.router_weights, transformer.dense_moe

    def counting_router(cfg_, logits):
        mix, idx = router_weights(cfg_, logits)
        if logits.shape[-2] == 1:
            hist.add_(torch.bincount(idx.flatten(), minlength=E))
        return mix, idx

    def capturing_moe(cfg_, lp, x):
        if (pool and x.shape[1] == 1
                and lp["router"].data_ptr() == check_router
                and sum(c.shape[0] for c in captured) < MOE_CHECK_TOKENS):
            captured.append(x.reshape(-1, x.shape[-1]).clone())
        return dense_moe(cfg_, lp, x)

    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["devices"] != 1:
                    raise AssertionError(f"{tag} /health: {r.status} "
                                         f"{health}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            queries = (list(QUERIES) if pool
                       else [_long_query(inner)])
            moe.router_weights = counting_router
            transformer.dense_moe = capturing_moe
            try:
                for fn in counted.values():
                    fn.launches = 0
                steps0 = inner.forward_steps if pool else 0
                dsteps0 = inner.decode_steps if pool else 0
                hits0 = inner._radix.hit_tokens_total if pool else 0
                t_burst = time.monotonic()
                burst = await asyncio.gather(*[ask(q) for q in queries])
                burst_s = time.monotonic() - t_burst
                burst_dsteps = (inner.decode_steps - dsteps0) if pool else 0
                hits1 = inner._radix.hit_tokens_total if pool else 0
                repeats = ([await ask(queries[i]) for i in REPEATS]
                           if pool else [])
                hits2 = inner._radix.hit_tokens_total if pool else 0
                launches = {name: fn.launches
                            for name, fn in counted.items()}
                steps = inner.forward_steps - steps0 if pool else 0
                dsteps = inner.decode_steps - dsteps0 if pool else 0
            finally:
                moe.router_weights = router_weights
                transformer.dense_moe = dense_moe
            profiled = (await _moe_profile(torch, transformer, ask, [
                q + " now" for q in (QUERIES if pool else QUERIES[:1])],
                (lambda: inner.forward_steps) if pool else (
                    lambda: sum(r.completion_tokens
                                for _, r in engine.results)),
                "forward steps" if pool else "tokens", f"profile_moe_{kind}")
                if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    # int4 launches of one forward: every packed projection of every
    # layer, and the head when it is packed.
    from ai_agent_kubectl_tpu_torch.ops.quant4 import QuantInt4

    int4_per_forward = (
        L * sum(isinstance(w, QuantInt4) for w in params["layers"].values())
        + isinstance(params.get("lm_head"), QuantInt4))
    if pool and (steps <= 0
                 or launches["ragged_attention_pool"] != L * steps
                 or launches["qmatmul4"] != int4_per_forward * steps):
        raise AssertionError(f"{tag}: launches {launches} for {steps} "
                             f"forward steps x {L} layers "
                             f"({int4_per_forward} int4 a forward)")
    if not pool and (launches["flash_attention_cached"] < L
                     or launches["qmatmul4"] < int4_per_forward):
        raise AssertionError(f"{tag}: launches {launches}")
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    sent = queries + [queries[i] for i in REPEATS] if pool else queries
    statuses = [st for st, _ in burst + repeats]
    for query, (status, body) in zip(sent, burst + repeats):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{tag} {query[:40]!r}: no tokens")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{tag} {query[:40]!r}: HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}: "
                                 f"{body}")
    firsts = [results[render_prompt(q)][0] for q in queries]
    hist_l = hist.tolist()
    info = {"startup_s": startup_s, "launches": launches,
            "statuses": statuses, "expert_histogram": hist_l,
            "profile": profiled}
    if pool:
        page = inner.kv_pool_page
        same = []
        for i in REPEATS:
            first, again = results[render_prompt(queries[i])]
            if not again.prefix_cache_hit:
                raise AssertionError(f"{tag}: the repeat of {queries[i]!r} "
                                     f"missed the radix cache")
            same.append(again.token_ids == first.token_ids)
        want_hits = sum(firsts[i].prompt_tokens - page for i in REPEATS)
        if hits2 - hits1 < want_hits:
            raise AssertionError(f"{tag}: the repeats radix-matched "
                                 f"{hits2 - hits1} tokens, want >= "
                                 f"{want_hits}")
        check_pool_books(inner)
        if sum(c.shape[0] for c in captured) < MOE_CHECK_TOKENS:
            raise AssertionError(f"{tag}: captured {len(captured)} decode "
                                 f"inputs of layer {MOE_CHECK_LAYER}")
        n_tok = sum(r.completion_tokens for r in firsts)
        ttft = sorted(r.ttft_ms for r in firsts)
        info.update(
            forward_steps=steps, burst_s=burst_s, burst_tokens=n_tok,
            burst_tok_per_s=n_tok / burst_s, decode_steps=dsteps,
            step_ms=burst_s * 1e3 / max(burst_dsteps, 1),
            ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
            radix_hit_tokens=[hits1 - hits0, hits2 - hits1],
            repeats_identical=same,
            decode_positions=[r.prompt_tokens + r.completion_tokens // 2
                              for r in firsts],
            kv_bytes=inner._cache.k.nbytes + inner._cache.v.nbytes,
            captured=torch.cat(captured)[:MOE_CHECK_TOKENS],
            logits=_check_served_logits(torch, inner, results, tag))
        log(f"[{tag}] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} "
            f"s ({info['burst_tok_per_s']:.1f} tok/s; {dsteps} decode steps "
            f"with the repeats), "
            f"TTFT p50 {info['ttft_ms_p50']:.0f} ms max "
            f"{info['ttft_ms_max']:.0f} ms; repeats hit "
            f"{hits2 - hits1} radix tokens, identical {same}; launches "
            f"{launches} over {steps} forward steps")
    else:
        res = firsts[0]
        decode_ms = res.decode_ms / max(res.completion_tokens - 1, 1)
        if not res.prefix_cache_hit:
            raise AssertionError(f"{tag}: the long query missed the prefix")
        cache_bytes = 2 * (L * (inner.max_seq_len + 1) * mcfg.n_kv_heads
                           * mcfg.head_dim * 2)
        info.update(
            prompt_tokens=res.prompt_tokens, tokens=res.completion_tokens,
            ttft_ms=res.ttft_ms, decode_ms_per_step=decode_ms,
            decode_tok_per_s=1e3 / decode_ms,
            kv_bytes=cache_bytes + inner._prefix.k.nbytes
            + inner._prefix.v.nbytes,
            logits=_check_served_logits1(torch, inner, res,
                                         render_prompt(queries[0]), tag))
        log(f"[{tag}] status {statuses}; {res.prompt_tokens}-token prompt, "
            f"TTFT {res.ttft_ms:.0f} ms, {res.completion_tokens} tokens at "
            f"{decode_ms:.2f} ms a decode step ({1e3 / decode_ms:.2f} "
            f"tok/s); launches {launches}")
    total = max(sum(hist_l), 1)
    log(f"[{tag}] routed experts over the decode steps (all layers): "
        + ", ".join(f"{e}: {n} ({n / total:.1%})"
                    for e, n in enumerate(hist_l)))
    # Nothing of this engine holds device memory past the phase's part.
    inner.params = None
    if pool:
        inner._cache = None
    return info


async def _moe_profile(torch, transformer, ask, queries, steps, unit: str,
                       tag: str) -> dict:
    """``_profile_burst`` with every MoE MLP call bracketed by CUDA
    events: the MoE MLP's time on the device's clock (event to event, so
    the device's waits inside it count too) against the burst's wall
    time and its steps. Only with ``--profile``."""
    moe_mlp = transformer._moe_mlp
    spans = []

    def timed_moe(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = moe_mlp(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    transformer._moe_mlp = timed_moe
    try:
        out = await _profile_burst(torch, ask, queries, steps, unit, tag)
    finally:
        transformer._moe_mlp = moe_mlp
    torch.cuda.synchronize()
    moe_ms = sum(a.elapsed_time(b) for a, b in spans)
    out.update(moe_ms=moe_ms, moe_calls=len(spans),
               moe_share_of_wall=moe_ms / out["wall_ms"],
               moe_ms_per_step=moe_ms / max(out["steps"], 1))
    log(f"[{tag}] MoE MLP: {moe_ms:.0f} ms over {len(spans)} calls, "
        f"{out['moe_ms_per_step']:.2f} ms per {unit[:-1]}, "
        f"{out['moe_share_of_wall']:.1%} of the wall time")
    return out


def _check_moe_mix(torch, cfg, params, x) -> dict:
    """The dense mix equals the sparse pick: the port's ``dense_moe``
    (every expert, mixed by the router's weights, bf16) on real hidden
    states of MOE_CHECK_LAYER against an independent float32 loop that
    evaluates only each token's two routed experts from the dequantized
    int8 weights. Routing is read off the same bf16 router product the
    model computes (the routing's definition, as in the JAX package),
    the picks taken by a host sort (lower index first on a tie). Gates:
    ``router_weights`` picks the same experts with the same weights (to
    float32 rounding), and the outputs meet the serve phase's rule,
    ``max |dense - sparse| <= LOGIT_RTOL * rms(sparse)``: the dense path
    rounds each expert's activations to bf16, about a percent of the
    rms on the worst value, where a wrong expert or weight moves values
    by the rms itself."""
    from ai_agent_kubectl_tpu_torch.parallel import moe

    layer = {k: v[MOE_CHECK_LAYER] for k, v in params["layers"].items()}
    with torch.no_grad():
        dense = moe.dense_moe(cfg, layer, x[None])[0].float()
        router_logits = (x @ layer["router"]).float()
        mix = moe.router_weights(cfg, router_logits)[0].cpu()
        logits = router_logits.cpu().tolist()
        k = cfg.experts_per_token
        picks = []
        for row in logits:
            top = sorted(range(len(row)), key=lambda e: (-row[e], e))[:k]
            m = max(row[e] for e in top)
            w = [math.exp(row[e] - m) for e in top]
            picks.append([(e, wi / sum(w)) for e, wi in zip(top, w)])
        xf = x.float()
        sparse = torch.zeros_like(xf)
        for e in range(cfg.n_experts):
            rows = [t for t, p in enumerate(picks) if e in dict(p)]
            if not rows:
                continue

            def deq(name):
                w = layer[name]
                return w.q[e].float() * w.scale[e]

            h = xf[rows] @ deq("w_gate")
            h = torch.nn.functional.silu(h) * (xf[rows] @ deq("w_up"))
            y = h @ deq("w_down")
            wts = torch.tensor([dict(picks[t])[e] for t in rows],
                               device=x.device)
            sparse[rows] += y * wts[:, None]
    want_mix = torch.zeros_like(mix)
    for t, p in enumerate(picks):
        for e, w in p:
            want_mix[t, e] = w
    if ((mix > 0) != (want_mix > 0)).any() or not torch.allclose(
            mix, want_mix, rtol=1e-5, atol=1e-6):
        raise AssertionError("router_weights' picks or weights differ from "
                             "the host's top-k")
    rms = float(sparse.pow(2).mean().sqrt())
    err = float((dense - sparse).abs().max())
    used = sorted({e for p in picks for e, _ in p})
    log(f"[serve_moe] dense mix vs sparse pick at layer {MOE_CHECK_LAYER} "
        f"over {x.shape[0]} served decode tokens: the same {k} experts "
        f"picked per token; max |dense - sparse| {err:.4f} (rms {rms:.4f}, "
        f"tolerance {LOGIT_RTOL * rms:.4f}); experts routed {used}")
    if err > LOGIT_RTOL * rms or not torch.isfinite(dense).all():
        raise AssertionError(
            f"dense_moe disagrees with the sparse top-{k} pick: max {err} > "
            f"{LOGIT_RTOL} x rms {rms}")
    return {"tokens": x.shape[0], "max_abs_err": err, "rms": rms,
            "tolerance": LOGIT_RTOL * rms, "experts_routed": used}


# The int8 KV cache (KV_QUANT=int8) on Llama-3-8B at full width, int4
# weights drawn on the card from seed 0, through the three engines of
# phase 9 in turn, each built from the environment-style config and
# served over HTTP. Every other knob keeps its default: 16-token pages
# and chunks, 128 new tokens, greedy, the prefix and radix caches on.
KVQ_MODEL = "llama-3-8b-instruct"
#: serve_kvq runs Llama-3-8B at a quarter of its published depth (8 of
#: 32 layers, every width unchanged), so that the whole script stays well
#: inside its time limit on a slow host (PHASE_LAYERS)
KVQ_LAYERS = 8
SERVE_KVQ_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": KVQ_MODEL, "DTYPE": "bfloat16", "QUANT": "int4",
    "KV_QUANT": "int8", "DECODE_BATCH_SIZE": str(N_SLOTS),
    "MAX_SEQ_LEN": "2048", "PREFILL_BUCKETS": "64,128,256,512",
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    "RATE_LIMIT": "1000/minute",
}
#: (a) the pool with RAGGED_ATTENTION and DECODE_ATTN at auto, (b) the
#: dense ladder with DECODE_ATTN=paged asked, (c) the single-sequence
#: engine (ATTN_IMPL at auto: flash asked on the card)
SERVE_KVQ_ENGINES = {
    "pool": {},
    "dense": {"KV_POOL": "false", "DECODE_ATTN": "paged"},
    "single": {"DECODE_BATCH_SIZE": "1"},
}
#: what each part must resolve to, and the log line that says why:
#: (decode impl, regime) of a batched engine, the single engine's
#: prefill attention
KVQ_RESOLVED = {
    "pool": (("dense", "gather"),
             "RAGGED_ATTENTION: the ragged pool kernel reads bf16 KV; int8 "
             "KV serves the gather path"),
    "dense": (("dense", "dense"),
              "DECODE_ATTN=paged does not read int8 KV; falling back to "
              "the dense KV ladder"),
    "single": (("dense",),
               "KV_QUANT=int8: prefill attention uses dense (fusable "
               "dequant) instead of flash"),
}
#: the KV cache's bytes against a bf16 cache of the same geometry
KVQ_BYTES_RATIO = 0.52
#: the W8A8 product's shapes (Llama-3-8B's wq and w_gate) and rows
KVQ_W8A8_SHAPES = {"wq": (4096, 4096), "w_gate": (4096, 14336)}
KVQ_W8A8_TS = (1, 8, 17, 64)


def kvq_cache_bytes(cfg, rows: int) -> tuple:
    """(int8, bf16) bytes of a K and V cache of ``rows`` positions a
    layer: head_dim int8 values and one f32 scale a (position, head),
    against head_dim bf16 values."""
    per = 2 * cfg.n_layers * rows * cfg.n_kv_heads
    return per * (cfg.head_dim + 4), per * cfg.head_dim * 2


def kvq_transient_bytes(cfg, max_seq: int, window: int) -> int:
    """A bound on the largest transient of phase 9, from the shapes:
    one prefill window's float32 scores over the whole span (six
    surfaces alive at once: the product, its scaling, the mask, the
    softmax, the V-scaled probabilities and their bf16 round trip), a
    decode step's gathered span of K and V for every slot (int8 and its
    float32 copy, 5 bytes an element), the window's MLP and streams (16
    bytes a [window, mlp_hidden] element, 32 a [window, dim] one), every
    slot's float32 logits twice, the logit check's own caches (one
    slot's int8 pool of the whole span and two one-slot dense caches of
    the span, one of them bf16) and the plain int4 version's unpacked
    copy of the largest packed weight, the untied head, which the check
    runs: 8 bytes an element (the int32 nibbles, their concatenation,
    then the int8, bf16 and float32 copies)."""
    from ai_agent_kubectl_tpu_torch.models.convert import expected_shapes
    from ai_agent_kubectl_tpu_torch.ops.quant4 import pick_format

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scores = 6 * 4 * H * window * max_seq
    span = 2 * 5 * N_SLOTS * max_seq * KV * hd
    mlp = window * (16 * cfg.mlp_hidden + 32 * cfg.dim)
    head = 2 * 4 * N_SLOTS * cfg.vocab_size
    check = (2 * kvq_cache_bytes(cfg, max_seq + 64)[0]
             + kvq_cache_bytes(cfg, max_seq + 64)[1])
    shapes = expected_shapes(cfg)
    packed = [s[-2:] for s in [shapes.get("lm_head", (1, 1)),
                               *shapes["layers"].values()]
              if len(s) in (2, 3) and pick_format(*s[-2:]) is not None]
    plain_int4 = 8 * max(i * o for i, o in packed)
    return scores + span + mlp + head + check + plain_int4


def phase_serve_kvq(torch, profile: bool = False) -> dict:
    """Phase 9: Llama-3-8B with int4 weights and the int8 KV cache, one
    parameter tree drawn once for (a) the pool engine, (b) the dense
    ladder and (c) the single-sequence engine; then the gap between
    int8-KV and bf16-KV logits on one prompt, the W8A8 product against
    the CPU's and the peak-memory gate. The tree is freed at the end."""
    import gc

    from ai_agent_kubectl_tpu_torch.ops.quant import random_params_int8

    release_served_apps(torch)
    cfg = cut_config(KVQ_MODEL, KVQ_LAYERS)
    max_seq = int(SERVE_KVQ_ENV["MAX_SEQ_LEN"])
    window = max(int(b) for b in SERVE_KVQ_ENV["PREFILL_BUCKETS"].split(","))
    want_tree = quantized_tree_bytes(cfg)
    transient = kvq_transient_bytes(cfg, max_seq, window)
    resident = torch.cuda.memory_allocated()
    log(f"[serve_kvq] {cfg.name}: {cfg.n_layers} layers, dim {cfg.dim}, "
        f"{cfg.n_heads} over {cfg.n_kv_heads} heads of {cfg.head_dim}, MLP "
        f"{cfg.mlp_hidden}, vocab {cfg.vocab_size}; int4 tree "
        f"{want_tree / 1e9:.3f} GB (derived from the shapes); int8 KV at "
        f"MAX_SEQ_LEN {max_seq}; the peak bound's transient "
        f"{transient / 1e9:.3f} GB (stated before the run); "
        f"{resident / 1e9:.3f} GB resident from earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = random_params_int8(
        torch.Generator(device="cuda").manual_seed(0), cfg,
        dtype=torch.bfloat16, quantize_embed=True, int4=True, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    tree = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[serve_kvq] random int4 tree drawn on the card in {init_s:.2f} s: "
        f"{tree / 1e9:.3f} GB")
    if tree != want_tree:
        raise AssertionError(f"tree of {tree} bytes, the shapes give "
                             f"{want_tree}")
    out = {"init_s": init_s, "tree_bytes": tree,
           "transient_bound_bytes": transient}
    try:
        for kind, env in SERVE_KVQ_ENGINES.items():
            out[kind] = asyncio.run(_serve_kvq_one(torch, kind, env, params,
                                                   profile))
            gc.collect()
        peak = torch.cuda.max_memory_allocated()
        kv = sum(out[k]["kv_bytes"] for k in SERVE_KVQ_ENGINES)
        bound = resident + tree + kv + transient
        out.update(peak_bytes=peak, peak_bound_bytes=bound)
        log(f"[serve_kvq] peak device memory {peak / 1e9:.3f} GB, bound "
            f"{bound / 1e9:.3f} GB = resident {resident / 1e9:.3f} + tree "
            f"{tree / 1e9:.3f} + the three engines' int8 KV "
            f"{kv / 1e9:.3f} + transient {transient / 1e9:.3f}")
        if peak > bound:
            raise AssertionError(f"peak device memory {peak} over the bound "
                                 f"{bound}")
        out["kv_gap"] = _kvq_logit_gap(torch, cfg, params,
                                       out["single"].pop("prompt_ids"))
        out["w8a8"] = _check_w8a8(torch)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


class _LogLines:
    """The records of the engine modules' loggers while in scope (INFO
    included), for the resolution gates."""

    NAMES = ("ai_agent_kubectl_tpu_torch.engine.batcher",
             "ai_agent_kubectl_tpu_torch.engine.torch_engine")

    def __enter__(self):
        import logging

        self.lines = []
        outer = self

        class Keep(logging.Handler):
            def emit(self, record):
                outer.lines.append(record.getMessage())

        self.handler = Keep()
        self.saved = []
        for name in self.NAMES:
            lg = logging.getLogger(name)
            self.saved.append((lg, lg.level))
            lg.setLevel(logging.INFO)
            lg.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for lg, level in self.saved:
            lg.removeHandler(self.handler)
            lg.setLevel(level)
        return False


async def _serve_kvq_one(torch, kind: str, env: dict, params,
                         profile: bool) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.quant import QuantKV
    from ai_agent_kubectl_tpu_torch.ops.quant4 import QuantInt4, qmatmul4
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_kvq/{kind}"
    counted = {"qmatmul4": qmatmul4,
               "ragged_attention_pool": ragged_attention_pool,
               "flash_attention_cached": flash_attention_cached,
               "paged_decode_attention_pool": paged_decode_attention_pool,
               "paged_decode_attention": paged_decode_attention}
    port = _free_port()
    _phase_env({**SERVE_KVQ_ENV, **env}, port)
    batched = kind != "single"
    with _LogLines() as logged:
        cfg = ServiceConfig.from_env()
        inner = build_engine(cfg)
        if type(inner) is not (BatchedTorchEngine if batched
                               else TorchEngine):
            raise AssertionError(f"{tag}: engine construction failed: "
                                 f"{inner!r}")
        inner.model_cfg = cut_config(KVQ_MODEL, KVQ_LAYERS)
        inner.params = params
        engine = RecordingEngine(inner)
        runner = web.AppRunner(create_app(cfg, engine), access_log=None)
        t0 = time.monotonic()
        await runner.setup()             # starts the engine (warm-up too)
        site = web.TCPSite(runner, cfg.host, cfg.port)
        await site.start()
        startup_s = time.monotonic() - t0
    mcfg = inner.model_cfg
    L = mcfg.n_layers
    want, why = KVQ_RESOLVED[kind]
    resolved = ((inner._decode_impl, inner._attention_regime) if batched
                else (inner.attn_impl,))
    log(f"[{tag}] {cfg.model_name} quant={inner.quant} "
        f"kv_quant={inner.kv_quant} up on {cfg.host}:{port} in "
        f"{startup_s:.1f} s; resolved {resolved}; prefill "
        f"{inner.attn_impl}; logged: "
        f"{[m for m in logged.lines if 'int8' in m]}")
    if resolved != want or not any(why in m for m in logged.lines):
        raise AssertionError(f"{tag}: resolved {resolved} (want {want}), "
                             f"log {logged.lines}")
    if batched and not any(KVQ_RESOLVED["single"][1] in m
                           for m in logged.lines):
        raise AssertionError(f"{tag}: flash prefill did not resolve to "
                             f"dense: {logged.lines}")
    if kind == "pool":
        queries = list(QUERIES)
    elif kind == "dense":
        queries = list(QUERIES)
        queries[-1] = _long_burst_query(inner.tokenizer)
    else:
        queries = [_long_query(inner)]
    sent = queries + ([queries[i] for i in REPEATS] if batched else [])
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                health = await r.json()
                if r.status != 200 or health["devices"] != 1:
                    raise AssertionError(f"{tag} /health: {r.status} "
                                         f"{health}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counted.values():
                fn.launches = 0
            steps0 = inner.forward_steps if batched else 0
            dsteps0 = inner.decode_steps if batched else 0
            hits0 = inner._radix.hit_tokens_total if kind == "pool" else 0
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in queries])
            burst_s = time.monotonic() - t_burst
            burst_dsteps = (inner.decode_steps - dsteps0) if batched else 0
            hits1 = inner._radix.hit_tokens_total if kind == "pool" else 0
            repeats = ([await ask(queries[i]) for i in REPEATS]
                       if batched else [])
            hits2 = inner._radix.hit_tokens_total if kind == "pool" else 0
            launches = {name: fn.launches for name, fn in counted.items()}
            steps = inner.forward_steps - steps0 if batched else 0
            profiled = (await _kvq_profile(
                torch, ask, [q + " now" for q in
                             (QUERIES if batched else QUERIES[:1])],
                (lambda: inner.decode_steps) if batched else (
                    lambda: sum(r.completion_tokens
                                for _, r in engine.results)),
                "decode steps" if batched else "tokens",
                f"profile_kvq_{kind}") if profile else None)
    finally:
        await runner.cleanup()           # drains and stops the engine

    int4_per_forward = (
        L * sum(isinstance(w, QuantInt4) for w in params["layers"].values())
        + isinstance(params.get("lm_head"), QuantInt4))
    others = {n: c for n, c in launches.items() if n != "qmatmul4"}
    if launches["qmatmul4"] < int4_per_forward or any(others.values()):
        raise AssertionError(f"{tag}: launches {launches} (the int4 kernel "
                             f"must run, no attention kernel may)")
    if kind == "pool" and launches["qmatmul4"] != int4_per_forward * steps:
        raise AssertionError(f"{tag}: {launches['qmatmul4']} int4 launches "
                             f"for {steps} forward steps x "
                             f"{int4_per_forward}")
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [st for st, _ in burst + repeats]
    for query, (status, body) in zip(sent, burst + repeats):
        res = results[render_prompt(query)][0]
        if res.completion_tokens <= 0:
            raise AssertionError(f"{tag} {query[:40]!r}: no tokens")
        want_status = status_for_text(res.text)
        if status != want_status:
            raise AssertionError(f"{tag} {query[:40]!r}: HTTP {status}, the "
                                 f"service gives {want_status} for "
                                 f"{res.text!r}: {body}")
    firsts = [results[render_prompt(q)][0] for q in queries]
    # The cache's bytes, read from its tensors, against the geometry.
    if batched:
        cache = inner._cache
        rows = (cache.n_blocks + 1) * cache.page if inner.kv_pool else (
            inner.batch_size * (cache.max_seq + 1))
        kv_bytes = cache.nbytes
        extra = 0
    else:
        cache = inner._new_cache()
        rows = cache.max_seq + 1
        kv_bytes = cache.nbytes
        extra = inner._prefix.k.nbytes + inner._prefix.v.nbytes
        if extra != kvq_cache_bytes(mcfg, inner._prefix.n)[0]:
            raise AssertionError(f"{tag}: prefix of {extra} bytes")
    int8_bytes, bf16_bytes = kvq_cache_bytes(mcfg, rows)
    if not (isinstance(cache.k, QuantKV) and cache.k.q.dtype == torch.int8
            and kv_bytes == int8_bytes
            and kv_bytes <= KVQ_BYTES_RATIO * bf16_bytes):
        raise AssertionError(f"{tag}: KV cache of {kv_bytes} bytes, want "
                             f"{int8_bytes} = 2 L rows KV (hd + 4) and at "
                             f"most {KVQ_BYTES_RATIO} x bf16 {bf16_bytes}")
    info = {"startup_s": startup_s, "resolved": list(resolved),
            "launches": launches, "statuses": statuses,
            "kv_rows": rows, "kv_bytes": kv_bytes + extra,
            "kv_bf16_bytes": bf16_bytes, "kv_ratio": kv_bytes / bf16_bytes,
            "profile": profiled}
    log(f"[{tag}] int8 KV cache {kv_bytes / 1e9:.4f} GB over {rows} rows "
        f"a layer, {kv_bytes / bf16_bytes:.4f} of bf16 "
        f"({bf16_bytes / 1e9:.4f} GB)"
        + (f"; prefix {extra / 1e6:.2f} MB" if extra else ""))
    if batched:
        for i in REPEATS:
            first, again = results[render_prompt(queries[i])]
            if not again.prefix_cache_hit:
                raise AssertionError(f"{tag}: the repeat of {queries[i]!r} "
                                     f"missed its prefix")
        if kind == "pool":
            want_hits = sum(firsts[i].prompt_tokens - inner.kv_pool_page
                            for i in REPEATS)
            if hits2 - hits1 < want_hits:
                raise AssertionError(f"{tag}: the repeats radix-matched "
                                     f"{hits2 - hits1} tokens, want >= "
                                     f"{want_hits}")
            check_pool_books(inner)
        n_tok = sum(r.completion_tokens for r in firsts)
        ttft = sorted(r.ttft_ms for r in firsts)
        info.update(
            forward_steps=steps, burst_s=burst_s, burst_tokens=n_tok,
            burst_tok_per_s=n_tok / burst_s,
            step_ms=burst_s * 1e3 / max(burst_dsteps, 1),
            ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
            prompt_tokens=[r.prompt_tokens for r in firsts],
            radix_hit_tokens=[hits1 - hits0, hits2 - hits1],
            repeats_identical=[
                results[render_prompt(queries[i])][1].token_ids
                == results[render_prompt(queries[i])][0].token_ids
                for i in REPEATS],
            logits=_check_kvq_logits(torch, inner, firsts[0],
                                     render_prompt(queries[0]), tag))
        log(f"[{tag}] statuses {statuses}; {n_tok} tokens in {burst_s:.2f} "
            f"s ({info['burst_tok_per_s']:.1f} tok/s, "
            f"{info['step_ms']:.2f} ms of burst wall a decode step), TTFT "
            f"p50 {info['ttft_ms_p50']:.0f} ms max {info['ttft_ms_max']:.0f}"
            f" ms; prompts {info['prompt_tokens']}; repeats identical "
            f"{info['repeats_identical']}; launches {launches} over {steps} "
            f"forward steps")
    else:
        res = firsts[0]
        decode_ms = res.decode_ms / max(res.completion_tokens - 1, 1)
        if not res.prefix_cache_hit:
            raise AssertionError(f"{tag}: the long query missed the prefix")
        if res.prompt_tokens - inner._prefix.n <= inner.prefill_buckets[-1]:
            raise AssertionError(f"{tag}: the long query's suffix fits one "
                                 f"bucket: no chunked prefill")
        prompt = render_prompt(queries[0])
        info.update(
            prompt_tokens=res.prompt_tokens, tokens=res.completion_tokens,
            ttft_ms=res.ttft_ms, decode_ms_per_step=decode_ms,
            decode_tok_per_s=1e3 / decode_ms,
            prompt_ids=inner.tokenizer.encode(prompt),
            logits=_check_served_logits1(torch, inner, res, prompt, tag))
        log(f"[{tag}] status {statuses}; {res.prompt_tokens}-token prompt, "
            f"TTFT {res.ttft_ms:.0f} ms, {res.completion_tokens} tokens at "
            f"{decode_ms:.2f} ms a decode step ({1e3 / decode_ms:.2f} "
            f"tok/s); launches {launches}")
    # Nothing of this engine holds device memory past the phase's part.
    inner.params = None
    inner._prefix = None
    if batched:
        inner._cache = None
    return info


def _check_kvq_logits(torch, engine, res, prompt, tag) -> dict:
    """One served prompt through the engine's forward from scratch over
    a fresh int8 cache of its layout — its prefill at the served shape
    (the gather path on the pool, the dense read on the dense ladder,
    both ``dense_attention_quant``) and one decode step fed the served
    first token at the smallest KV bucket covering it — against the
    same two forwards with the int4 kernel's plain version, on the card
    (the serve phase's rule, ``_logit_gate``, on each step)."""
    from ai_agent_kubectl_tpu_torch.models import transformer

    cfg, dev = engine.model_cfg, engine.device
    ids = engine.tokenizer.encode(prompt)
    P = len(ids)
    bucket, kv_limit = (engine._pool_prefill_shape(P) if engine.kv_pool
                        else (engine._bucket_for(P),) * 2)
    if bucket < P:
        raise AssertionError(f"{tag}: the check's prompt of {P} tokens "
                             f"needs more than one window")
    cols = torch.arange(bucket, dtype=torch.int32, device=dev)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :P] = torch.tensor(ids, device=dev)
    served = [int(t) for t in res.token_ids[:2]]
    decode_kv = next(b for b in engine._kv_buckets if b >= P + 1)

    def run():
        if engine.kv_pool:
            pages = engine._pool_max_pages
            cache = transformer.KVCache.pool(
                cfg, pages, engine.kv_pool_page, dtype=engine.dtype,
                device=dev, kv_quant=engine.kv_quant)
            kw = dict(block_tables=torch.arange(
                pages, dtype=torch.int32, device=dev)[None])
        else:
            cache = transformer.KVCache.zeros(
                cfg, 1, engine._S_alloc, dtype=engine.dtype, device=dev,
                kv_quant=engine.kv_quant)
            kw = {}
        first, _ = transformer.forward(
            engine.params, cfg, tokens, cols[None], cache,
            kv_limit=kv_limit, attn_impl=engine._prefill_impl_for(
                bucket, kv_limit), write_mask=(cols < P)[None],
            logits_at=torch.tensor([P - 1], device=dev), **kw)
        second, _ = transformer.forward(
            engine.params, cfg,
            torch.tensor([[served[0]]], dtype=torch.int32, device=dev),
            torch.tensor([[P]], dtype=torch.int32, device=dev), cache,
            kv_limit=decode_kv, attn_impl=engine._decode_impl, **kw)
        return torch.stack([first[0, 0], second[0, 0]]).float()

    kernel, plain = _kernel_and_plain(torch, run)
    out = {"prompt_tokens": P, "decode_kv_limit": decode_kv}
    for i, step in enumerate(("prefill", "decode")):
        out[step] = _logit_gate(torch, kernel[i], plain[i], served[i],
                                f"({step}) over {P} prompt tokens", tag)
    return out


def _kvq_logit_gap(torch, cfg, params, ids) -> dict:
    """What int8 KV costs in accuracy, on the card (printed, not gated):
    one prompt prefilled in one window through the dense read over a
    bf16 cache and over an int8 cache of the same tree, the last
    position's logits compared as the rms and the max of their
    difference against the bf16 logits' rms, and whether the argmax
    agrees."""
    from ai_agent_kubectl_tpu_torch.models import transformer

    P = len(ids)
    dev = params["final_norm"].device
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None]
    logits = {}
    with torch.no_grad():
        for kv_quant in ("", "int8"):
            cache = transformer.KVCache.zeros(
                cfg, 1, P, dtype=params["final_norm"].dtype, device=dev,
                kv_quant=kv_quant)
            out, _ = transformer.forward(
                params, cfg, tokens, positions, cache, kv_limit=P,
                attn_impl="dense",
                logits_at=torch.tensor([P - 1], device=dev))
            logits[kv_quant or "bf16"] = out[0, 0].float()
            del cache
    ref, q = logits["bf16"], logits["int8"]
    rms = float(ref.pow(2).mean().sqrt())
    d = q - ref
    gap = {"prompt_tokens": P, "rms": rms,
           "rms_gap": float(d.pow(2).mean().sqrt()) / rms,
           "max_gap": float(d.abs().max()) / rms,
           "argmax_same": int(q.argmax()) == int(ref.argmax())}
    log(f"[serve_kvq] int8 KV against bf16 KV over a {P}-token prompt: "
        f"rms of the logit difference {gap['rms_gap']:.4f} and its max "
        f"{gap['max_gap']:.4f} of the bf16 logits' rms {rms:.3f}; argmax "
        f"{'the same' if gap['argmax_same'] else 'differs'}")
    return gap


def _check_w8a8(torch) -> dict:
    """The W8A8 product's int32 result on the card (``torch._int_mm``,
    rows padded past 16) equal to the CPU's (an int32 matmul) bit for
    bit, at Llama-3-8B's wq and w_gate for T in KVQ_W8A8_TS; and the
    whole W8A8 ``qmatmul`` (per-token activation quantization and the
    f32 epilogue) on a bf16 x, its largest difference from the CPU's
    printed."""
    from ai_agent_kubectl_tpu_torch.ops.quant import (
        QuantInt8W8A8, int8_matmul, qmatmul, quantize_int8)

    gen = torch.Generator().manual_seed(8)
    out = {}
    for name, (IN, OUT) in KVQ_W8A8_SHAPES.items():
        w = quantize_int8(torch.randn((IN, OUT), generator=gen) * IN ** -0.5)
        w = QuantInt8W8A8(q=w.q, scale=w.scale)
        w_d = QuantInt8W8A8(q=w.q.cuda(), scale=w.scale.cuda())
        for T in KVQ_W8A8_TS:
            xq = torch.randint(-127, 128, (T, IN), generator=gen,
                               dtype=torch.int8)
            cpu = int8_matmul(xq, w.q)
            card = int8_matmul(xq.cuda(), w_d.q).cpu()
            x = torch.randn((T, IN), generator=gen).to(torch.bfloat16)
            y_cpu = qmatmul(x, w).float()
            y_card = qmatmul(x.cuda(), w_d).float().cpu()
            diff = float((y_card - y_cpu).abs().max())
            label = f"{name}_T{T}"
            out[label] = {"int32_equal": torch.equal(card, cpu),
                          "qmatmul_max_abs_diff": diff}
            same = out[label]["int32_equal"]
            log(f"[serve_kvq] W8A8 {label} ({IN}x{OUT}): int32 product on "
                f"the card {'equals' if same else 'DIFFERS FROM'} the "
                f"CPU's; qmatmul max |card - cpu| {diff:.3e}")
            if card.dtype != torch.int32 or not out[label]["int32_equal"]:
                raise AssertionError(f"W8A8 {label}: the card's int32 "
                                     f"product differs from the CPU's")
    return out


async def _kvq_profile(torch, ask, queries, steps, unit: str,
                       tag: str) -> dict:
    """``_profile_burst`` with CUDA events around every gather through
    the block table and every ``dense_attention_quant`` call: their
    share of the burst's wall time and their ms a step. Then, on the
    last decode-shaped call's inputs, the int8 -> float32 convert of the
    span (both leaves) against the whole call, each timed alone. Only
    with ``--profile``."""
    from ai_agent_kubectl_tpu_torch.models import transformer

    gather = transformer._pool_gather
    attend = transformer.dense_attention_quant
    spans = {"gather": [], "attention": []}
    last = {}

    def timed(kind, fn):
        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[kind].append((a, b))
            if kind == "attention" and args[0].shape[1] == 1:
                last["args"] = args
            return out
        return call

    transformer._pool_gather = timed("gather", gather)
    transformer.dense_attention_quant = timed("attention", attend)
    try:
        out = await _profile_burst(torch, ask, queries, steps, unit, tag)
    finally:
        transformer._pool_gather = gather
        transformer.dense_attention_quant = attend
    torch.cuda.synchronize()
    for kind, ev in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in ev)
        out[f"{kind}_ms"] = ms
        out[f"{kind}_calls"] = len(ev)
        out[f"{kind}_share_of_wall"] = ms / out["wall_ms"]
        out[f"{kind}_ms_per_step"] = ms / max(out["steps"], 1)
    if "args" in last:
        q, k_q, k_s, v_q, v_s, mask = last["args"]
        whole = time_cuda(torch, lambda: attend(q, k_q, k_s, v_q, v_s, mask),
                          iters=20)["ms"]
        convert = time_cuda(torch, lambda: (k_q.float(), v_q.float()),
                            iters=20)["ms"]
        out.update(decode_attention_ms=whole, decode_convert_ms=convert,
                   convert_share_of_attention=convert / whole,
                   decode_span=list(k_q.shape))
    log(f"[{tag}] gather {out['gather_ms']:.0f} ms over "
        f"{out['gather_calls']} calls ({out['gather_share_of_wall']:.1%} of "
        f"the wall), dense_attention_quant {out['attention_ms']:.0f} ms over "
        f"{out['attention_calls']} calls "
        f"({out['attention_share_of_wall']:.1%}); "
        + (f"a decode call over {out['decode_span']}: "
           f"{out['decode_attention_ms']:.4f} ms, of which the int8 -> "
           f"float32 convert {out['decode_convert_ms']:.4f} ms "
           f"({out['convert_share_of_attention']:.1%})"
           if "args" in last else "no decode call"))
    return out


def kernel_breakdown(torch, fn, *, iters: int = 10) -> dict:
    """Device microseconds per launch of each of the port's kernels that
    ``fn`` launches (an attention kernel and its split combine, say), the
    mean over ``iters`` calls under ``torch.profiler``, each after
    time_cuda's L2 flush. PyTorch's own kernels (the flush, a memset) are
    left out, and each kernel's time is divided by its own count of
    records, not by ``iters``: a profiler that drops records then still
    reads the right mean. Only with ``--profile``."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.zeros(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            scratch.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.sub(r"\(anonymous namespace\)::|^void |\(.*$", "", e.key)
        if name.startswith("at::") or name.startswith("Memset") or not e.count:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            out[name] = float(us) / e.count
    return out


def timed(torch, kernel, plain, library, *, iters: int,
          profile: bool = False) -> dict:
    """Kernel, plain, library, kernel, in turns (L2 flushed before every
    call). ``spin_check`` keeps, for each of the four timings, the host's
    longest call, the shortest spin, the calls left uncovered and the
    calls taken. With ``profile``, ``kernels_us`` splits the kernel's
    call into the kernels it launches (kernel_breakdown)."""
    runs = [time_cuda(torch, fn, iters=iters)
            for fn in (kernel, plain, library, kernel)]
    k1, p, lib, k2 = (r["ms"] for r in runs)
    out = {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
           "plain_ms": p, "library_ms": lib,
           "spin_check": [[r["host_ms_max"], r["spin_ms_min"],
                           r["uncovered"], r["calls"]] for r in runs]}
    if profile:
        out["kernels_us"] = kernel_breakdown(torch, kernel)
    return out


def with_bound(entry: dict, nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    entry.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, flops=flops)
    return entry


def log_timing(what: str, entry: dict, library: str) -> None:
    k1, k2 = entry["kernel_ms_runs"]
    check = ", ".join(f"{h:.3f}/{sp:.3f}/{u} of {n}"
                      for h, sp, u, n in entry["spin_check"])
    log(f"[timing] {what}: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, {library} {entry['library_ms']:.4f} "
        f"ms, bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}); "
        f"host max / spin min ms / uncovered: {check}")
    if "kernels_us" in entry:
        log(f"[timing]   device us per launch: " + ", ".join(
            f"{k} {v:.2f}" for k, v in entry["kernels_us"].items()))


def _timing_flash(torch, gen, profile: bool) -> dict:
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached, flash_attention_cached_plain)

    shapes = {"S85": flash_case(torch, gen, S=85, KVLEN=128),
              "S512": flash_case(torch, gen, S=512, KVLEN=512),
              # serve_paged's prefill window at Llama-3-8B's grouping.
              "llama_S128": flash_case(torch, gen, S=128, KVLEN=128,
                                       **LLAMA),
              # serve_host (b)'s turn 2 after its radix hit (Gemma-2B).
              "g2b_S256_off192": flash_case(torch, gen, S=256, KVLEN=256,
                                            offset=192, **G2B),
              # serve_paged (a)'s group admission: 7 rows and a padding
              # row at kpad 8 (Llama-3-8B), and a four-slot Gemma-2B's.
              "llama_group_B8": group_flash_case(
                  torch, gen, geometry=LLAMA, B=8, S=64, KVLEN=128, live=7),
              "g2b_group_B4": group_flash_case(
                  torch, gen, geometry=G2B, B=4, S=64, KVLEN=128, live=4)}
    out = {}
    for label, case in shapes.items():
        q, k, v, mask = flash_sdpa_inputs(torch, case)
        gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
        entry = timed(
            torch, lambda: flash_attention_cached(**case),
            lambda: flash_attention_cached_plain(**case),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   **gqa),
            iters=20, profile=profile)
        out[label] = with_bound(entry, *flash_live_work(case))
        log_timing(f"flash {label}", entry, "sdpa")
    return out


def _timing_int4(torch, gen, profile: bool) -> dict:
    from ai_agent_kubectl_tpu_torch.ops.quant4 import (
        dequantize_int4, pick_format, qmatmul4, qmatmul4_plain)

    out = {}
    # T = 40: serve_spec's verify forward, 8 slots x (k + 1) = 5 rows.
    for name, (IN, OUT) in G7_PROJ.items():
        for T in (1, SPEC_VERIFY_ROWS, 64, 512):
            x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT,
                             fmt=(512, 512))
            dense = dequantize_int4(w, torch.bfloat16)
            entry = timed(torch, lambda: qmatmul4(x, w),
                          lambda: qmatmul4_plain(x, w),
                          lambda: torch.matmul(x, dense),
                          iters=10 if T == 512 else 50, profile=profile)
            label = f"{name}_T{T}"
            out[label] = with_bound(entry, *int4_work(x, w))
            del dense
            log_timing(f"int4 {label} ({IN}x{OUT})", entry, "bf16 matmul")
    # serve_moe's attention projections and head (Mixtral-8x7B).
    for name, ((IN, OUT), fmt) in MIXTRAL_PROJ.items():
        for T in ((1, 8) if name == "lm_head" else (1, 64, 512)):
            x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT, fmt=fmt)
            dense = dequantize_int4(w, torch.bfloat16)
            entry = timed(torch, lambda: qmatmul4(x, w),
                          lambda: qmatmul4_plain(x, w),
                          lambda: torch.matmul(x, dense),
                          iters=10 if T == 512 else 50, profile=profile)
            label = f"mixtral_{name}_T{T}"
            out[label] = with_bound(entry, *int4_work(x, w))
            del dense
            log_timing(f"int4 {label} ({IN}x{OUT}, {fmt[0]}/{fmt[1]})",
                       entry, "bf16 matmul")
    # serve_kvq's MLP, wk/wv and head projections (Llama-3-8B).
    for name, (IN, OUT) in LLAMA_PROJ.items():
        fmt = pick_format(IN, OUT)
        for T in LLAMA_TS:
            x, w = int4_case(torch, gen, T=T, IN=IN, OUT=OUT, fmt=fmt)
            dense = dequantize_int4(w, torch.bfloat16)
            entry = timed(torch, lambda: qmatmul4(x, w),
                          lambda: qmatmul4_plain(x, w),
                          lambda: torch.matmul(x, dense),
                          iters=10 if T == 512 else 50, profile=profile)
            label = f"llama_{name}_T{T}"
            out[label] = with_bound(entry, *int4_work(x, w))
            del dense
            log_timing(f"int4 {label} ({IN}x{OUT}, {fmt[0]}/{fmt[1]})",
                       entry, "bf16 matmul")
    return out


def phase_timing(torch, serve_info: dict, paged_info: dict,
                 moe_info: dict, spec_info: dict, host_info: dict,
                 tp_info: dict, profile: bool = False,
                 spec_tp_info: dict = None, moe_ep_info: dict = None) -> dict:
    from ai_agent_kubectl_tpu_torch.ops import paged_attention
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.quant4 import qmatmul4
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)

    counted = (ragged_attention_pool, flash_attention_cached, qmatmul4,
               paged_attention.paged_decode_attention,
               paged_attention.paged_decode_attention_pool)
    saved = [fn.launches for fn in counted]
    gen = torch.Generator(device="cuda").manual_seed(7)
    # The method's floor: the reading of a call that launches nothing.
    empty = time_cuda(torch, lambda: None, iters=50)
    log(f"[timing] an empty call reads {empty['ms']:.5f} ms (host up to "
        f"{empty['host_ms_max']:.4f} ms, spin {empty['spin_ms_min']:.3f} ms)")
    out = {"empty_call": empty,
           "ragged_attention": _timing_ragged(torch, serve_info, moe_info,
                                              spec_info, profile),
           "flash_attention": _timing_flash(torch, gen, profile),
           "int4_matmul": _timing_int4(torch, gen, profile),
           **_timing_paged(torch, gen, paged_info, host_info, profile),
           **_timing_sharded(torch, gen, tp_info, profile)}
    for name, shapes in _timing_mesh(torch, gen, spec_tp_info or {},
                                     moe_ep_info or {}, profile).items():
        out[name].update(shapes)
    # Timing launches do not count.
    for fn, n in zip(counted, saved):
        fn.launches = n
    return out


def _timing_paged(torch, gen, paged_info: dict, host_info: dict,
                  profile: bool) -> dict:
    """Both paged entry points at Llama-3-8B's grouping, page 64, 8 slots
    at the final positions the serve_paged burst reached (each engine's
    own), and the pool's at Gemma-2B's, page 64, at the positions of
    serve_host (b)'s last decode step; the library call SDPA over the
    gathered live span with a key mask."""
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_attention_pool, paged_decode_attention_pool_plain)

    out = {}
    for kind, name, kernel, plain in (
            ("dense", "paged_decode_attention", paged_decode_attention,
             paged_decode_attention_plain),
            ("pool", "paged_decode_attention_pool",
             paged_decode_attention_pool,
             paged_decode_attention_pool_plain)):
        positions = (paged_info.get(kind, {}).get("final_positions")
                     or [213, 213, 213, 213, 213, 213, 213, 728])
        positions = [p - 1 for p in positions]  # the last step's query
        case = paged_case(torch, gen, H=LLAMA_HEADS, KV=LLAMA_KV,
                          hd=LLAMA_HD, page=64, positions=positions)[kind]
        q, kc, vc, mask = paged_sdpa_inputs(torch, case, kind == "pool")
        entry = timed(
            torch, lambda: kernel(**case), lambda: plain(**case),
            lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, enable_gqa=True),
            iters=50, profile=profile)
        entry["positions"] = positions
        out[name] = {"decode": with_bound(
            entry, *paged_live_work(case, kind == "pool"))}
        log_timing(f"paged {kind} decode at {positions}", entry, "sdpa")
    checks = host_info.get("paged", {}).get("kernel_checks", [])
    positions = next((c["positions"] for c in checks
                      if c["kernel"] == "paged_decode_attention_pool"),
                     [260] * N_SLOTS)
    positions = [max(p, 0) for p in positions]
    case = paged_case(torch, gen, page=64, positions=positions,
                      span=G2B_POOL_SPAN, **G2B)["pool"]
    q, kc, vc, mask = paged_sdpa_inputs(torch, case, True)
    entry = timed(
        torch, lambda: paged_decode_attention_pool(**case),
        lambda: paged_decode_attention_pool_plain(**case),
        lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True),
        iters=50, profile=profile)
    entry["positions"] = positions
    out["paged_decode_attention_pool"]["gemma2b_p64_decode"] = with_bound(
        entry, *paged_live_work(case, True))
    log_timing(f"paged pool decode, Gemma-2B page 64, at {positions}", entry,
               "sdpa")
    return out


def _timing_sharded(torch, gen, tp_info: dict, profile: bool) -> dict:
    """One shard's launch of each sharded wrapper at Llama-3-8B's tp=2
    (16 query heads over 4 KV heads of 128): ragged decode (page 16)
    and paged pool decode (page 64), 8 slots at the positions serve_tp
    (a) reached at its last decode step; the library call SDPA over the
    shard's gathered live span. The bound is one shard's work."""
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool, paged_decode_attention_pool_plain)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain)

    shard = dict(H=LLAMA_HEADS // 2, KV=LLAMA_KV // 2, hd=LLAMA_HD)
    positions = (tp_info.get("runs", {}).get("ragged", {})
                 .get("decode_positions")
                 or [96, 112, 128, 144, 160, 176, 192, 208])
    case = ragged_case(torch, gen, W=1, positions=positions,
                       q_lens=[1] * len(positions), nan_block=False, **shard)
    q, kc, vc, mask = sdpa_inputs(torch, case)
    entry = timed(
        torch, lambda: ragged_attention_pool(**case, page_size=PAGE),
        lambda: ragged_attention_pool_plain(**case, page_size=PAGE),
        lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True),
        iters=50, profile=profile)
    entry["positions"] = positions
    out = {"ragged_attention_pool_sharded": {
        "decode": with_bound(entry, *ragged_live_work(case))}}
    log_timing(f"ragged decode, one shard of Llama-3-8B tp=2, at "
               f"{positions}", entry, "sdpa")
    pcase = paged_case(torch, gen, page=64, positions=positions,
                       **shard)["pool"]
    q, kc, vc, mask = paged_sdpa_inputs(torch, pcase, True)
    entry = timed(
        torch, lambda: paged_decode_attention_pool(**pcase),
        lambda: paged_decode_attention_pool_plain(**pcase),
        lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True),
        iters=50, profile=profile)
    entry["positions"] = positions
    out["paged_decode_attention_pool_sharded"] = {
        "decode": with_bound(entry, *paged_live_work(pcase, True))}
    log_timing(f"paged pool decode, one shard of Llama-3-8B tp=2, page 64, "
               f"at {positions}", entry, "sdpa")
    return out


def _timing_mesh(torch, gen, spec_tp_info: dict, moe_ep_info: dict,
                 profile: bool) -> dict:
    """One shard's launch at the shapes serve_spec_tp and serve_moe_ep (d)
    give the kernels: the ragged verify window (k = 4) of Gemma-7B tp=2
    (8 over 8 heads of 256) at serve_spec_tp's positions halfway; the
    dense paged decode at a (data, model) shard of Mixtral (4 slots, 16
    over 4 heads of 128, page 64) at (d)'s last decode positions; flash
    at a model shard of Mixtral's prompt prefill of 128 (KVLEN 128). The
    library call is SDPA over the shard's (gathered)
    live span; the bound is one shard's work."""
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached, flash_attention_cached_plain)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain)

    g7_shard = dict(H=G7_HEADS // TP, KV=G7_HEADS // TP, hd=G7_HD)
    mix_shard = dict(H=LLAMA_HEADS // MESH_TP, KV=LLAMA_KV // MESH_TP,
                     hd=LLAMA_HD)
    positions = (spec_tp_info.get("verify_positions")
                 or [96, 112, 128, 144, 160, 176, 192, 208])
    case = ragged_case(torch, gen, W=SPEC_K + 1, positions=positions,
                       q_lens=[SPEC_K + 1] * len(positions),
                       nan_block=False, **g7_shard)
    q, kc, vc, mask = sdpa_inputs(torch, case)
    entry = timed(
        torch, lambda: ragged_attention_pool(**case, page_size=PAGE),
        lambda: ragged_attention_pool_plain(**case, page_size=PAGE),
        lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask),
        iters=50, profile=profile)
    entry["positions"] = positions
    out = {"ragged_attention_pool_sharded": {
        "g7_tp2_verify5": with_bound(entry, *ragged_live_work(case))}}
    log_timing(f"ragged verify window (k = {SPEC_K}), one shard of "
               f"Gemma-7B tp=2, at {positions}", entry, "sdpa")
    d_pos = (moe_ep_info.get("runs", {}).get("dp2_ep2_tp2", {})
             .get("decode_positions") or [100, 101, 102, 103])
    pcase = paged_case(torch, gen, page=64, positions=d_pos,
                       **mix_shard)["dense"]
    q, kc, vc, mask = paged_sdpa_inputs(torch, pcase, False)
    entry = timed(
        torch, lambda: paged_decode_attention(**pcase),
        lambda: paged_decode_attention_plain(**pcase),
        lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True),
        iters=50, profile=profile)
    entry["positions"] = d_pos
    out["paged_decode_attention"] = {
        "mixtral_dp_tp_shard": with_bound(entry,
                                          *paged_live_work(pcase, False))}
    log_timing(f"paged dense decode, one (data, model) shard of Mixtral, "
               f"at {d_pos}", entry, "sdpa")
    fcase = flash_case(torch, gen, S=128, KVLEN=128, **mix_shard)
    q, k, v, mask = flash_sdpa_inputs(torch, fcase)
    entry = timed(
        torch, lambda: flash_attention_cached(**fcase),
        lambda: flash_attention_cached_plain(**fcase),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               enable_gqa=True),
        iters=20, profile=profile)
    out["flash_attention"] = {
        "mixtral_tp_shard_S128": with_bound(entry, *flash_live_work(fcase))}
    log_timing("flash prefill S 128, one model shard of Mixtral", entry,
               "sdpa")
    return out


def _timing_ragged(torch, serve_info: dict, moe_info: dict,
                   spec_info: dict, profile: bool) -> dict:
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool, ragged_attention_pool_plain)

    gen = torch.Generator(device="cuda").manual_seed(99)
    decode_pos = serve_info.get("decode_positions") or [
        96, 112, 128, 144, 160, 176, 192, 208]
    moe_pos = moe_info.get("pool", {}).get("decode_positions") or [
        96, 112, 128, 144, 160, 176, 192, 208]
    spec_pos = spec_info.get("http", {}).get("verify_positions") or [
        96, 112, 128, 144, 160, 176, 192, 208]
    shapes = {
        # The serving loop's decode step: one query per slot.
        "decode": ragged_case(torch, gen, W=1, positions=decode_pos,
                              q_lens=[1] * N_SLOTS, nan_block=False),
        # A prefill span of 512 in every slot.
        "prefill512": ragged_case(torch, gen, W=512,
                                  positions=[0] * N_SLOTS,
                                  q_lens=[512] * N_SLOTS, nan_block=False),
        # The mixed prologue: two admissions and six decode steps.
        "prologue64": ragged_case(torch, gen, **PROLOGUE64,
                                  nan_block=False),
        # serve_moe's decode step (Mixtral: 32 over 8 heads of 128).
        "mixtral_decode": ragged_case(torch, gen, W=1, positions=moe_pos,
                                      q_lens=[1] * N_SLOTS,
                                      nan_block=False, **MIXTRAL),
        # serve_spec's verify window (Gemma-7B, k = 4) at the positions
        # its burst reached halfway.
        "g7_verify5": ragged_case(torch, gen, W=SPEC_K + 1,
                                  positions=spec_pos,
                                  q_lens=[SPEC_K + 1] * N_SLOTS,
                                  nan_block=False, **G7),
    }
    out = {}
    for label, case in shapes.items():
        q, kc, vc, mask = sdpa_inputs(torch, case)
        page = case["k"].shape[1]
        entry = timed(
            torch, lambda: ragged_attention_pool(**case, page_size=page),
            lambda: ragged_attention_pool_plain(**case, page_size=page),
            lambda: F.scaled_dot_product_attention(
                q, kc, vc, attn_mask=mask, enable_gqa=True),
            iters=10 if label == "prefill512" else 50, profile=profile)
        out[label] = with_bound(entry, *ragged_live_work(case))
        log_timing(f"ragged {label}", entry, "sdpa")
    return out


def kernel_lines(results: dict) -> list:
    """One entry per kernel for the ``kernels`` line: launches from its
    serving run (ragged: phase 3; flash and int4: phase 4; the paged
    entry points: their engines of phase 5), the worst
    error of phase 2, and the times at the shape its serving path runs
    most at the top level (every timed shape under ``shapes``);
    ``phase_launches`` adds the launches of phase 6 (ragged in its bf16
    engine, flash and int4 in its int4 engine), of phase 7 (both its
    engines) and of phase 8 (both its engines: every kernel counted,
    those off its path at 0), of phase 9 (its three engines: the int4
    kernel's, the attention kernels' at 0), of phase 11 (both its
    engines: ragged in the pool, flash and paged on the dense ladder) and
    of phase 12 (its HTTP engine and its four ByteTokenizer engines: the
    ragged kernel's, the others' at 0) and of phase 13 (its HTTP engine:
    ragged and int4; its spec-on Gemma-2B engines and the drill: ragged;
    not its spec-off reference engines) and of phase 14 (both its HTTP
    engines' session traffic: ragged in (a), paged pool and flash in
    (b))."""
    timing = results.get("timing", {})
    kernel = results.get("kernel", {})
    serve1 = results.get("serve1", {}).get("launches", {})
    ckpt = results.get("serve_ckpt", {})
    ckpt_launches = {
        "ragged_attention_pool": ckpt.get("bf16", {}).get("launches"),
        "flash_attention_cached": ckpt.get("int4", {}).get(
            "launches", {}).get("flash_attention"),
        "qmatmul4": ckpt.get("int4", {}).get("launches", {}).get(
            "int4_matmul"),
    }
    tol = f"|kernel - plain| <= {ATOL} + {RTOL}*|plain| (bf16)"
    qos = results.get("serve_qos", {})

    def qos_launches(name):
        counts = [qos[k]["launches"].get(name) for k in ("pool", "dense")
                  if k in qos]
        return sum(counts) if counts and None not in counts else None

    paged = results.get("serve_paged", {})
    moe = results.get("serve_moe", {})

    def moe_launches(name):
        counts = [moe[k]["launches"].get(name) for k in ("pool", "single")
                  if k in moe]
        return sum(counts) if counts and None not in counts else None

    kvq = results.get("serve_kvq", {})

    def kvq_launches(name):
        counts = [kvq[k]["launches"].get(name) for k in SERVE_KVQ_ENGINES
                  if k in kvq]
        return sum(counts) if counts and None not in counts else None

    chaos = results.get("serve_chaos", {})

    def chaos_launches(name):
        counts = [chaos[k]["launches"].get(name) for k in ("pool", "dense")
                  if k in chaos]
        return sum(counts) if counts and None not in counts else None

    grammar = results.get("serve_grammar", {}).get("launches", {})
    spec = results.get("serve_spec", {}).get("launches", {})
    host = results.get("serve_host", {}).get("launches", {})
    fleet = results.get("serve_fleet", {}).get("launches", {})
    pipe = results.get("serve_pipe", {}).get("launches", {})
    tp_runs = results.get("serve_tp", {}).get("runs", {})
    spec_tp = results.get("serve_spec_tp", {}).get("launches", {})
    moe_ep = results.get("serve_moe_ep", {}).get("launches", {})
    ring = results.get("serve_ring", {}).get("launches", {})
    pp = results.get("serve_pp", {}).get("launches", {})
    dcn = results.get("serve_dcn", {}).get("launches", {})
    ring_decode = kernel.get("paged_decode_attention", {}).get("ring_decode")

    def tp_launches(name):
        counts = [r["launches"].get(name) for r in tp_runs.values()]
        return sum(counts) if counts and None not in counts else None

    def entry(name, source, replaces, launches, err, shapes, main,
              library):
        top = shapes.get(main, {})
        return {
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "tolerance": tol,
            "shape": main,
            "ms": top.get("kernel_ms"), "kernel_ms": top.get("kernel_ms"),
            "plain_ms": top.get("plain_ms"),
            "bound_ms": top.get("bound_ms"),
            "bound_by": top.get("bound_by"),
            "library_ms": top.get("library_ms"), "library": library,
            "phase_launches": {"serve_ckpt": ckpt_launches.get(name),
                               "serve_paged_group": (
                                   paged.get("dense", {}).get(
                                       "launches", {}).get("flash_group")
                                   if name == "flash_attention_cached"
                                   else None),
                               "serve_qos": qos_launches(name),
                               "serve_moe": moe_launches(name),
                               "serve_kvq": kvq_launches(name),
                               "serve_chaos": chaos_launches(name),
                               "serve_grammar": grammar.get(name),
                               "serve_spec": spec.get(name),
                               "serve_host": host.get(name),
                               "serve_fleet": fleet.get(name),
                               "serve_pipe": pipe.get(name),
                               "serve_tp": tp_launches(name),
                               "serve_spec_tp": spec_tp.get(name),
                               "serve_moe_ep": moe_ep.get(name),
                               "serve_ring": ring.get(name),
                               "serve_pp": pp.get(name),
                               "serve_dcn": dcn.get(name)},
            "shapes": shapes,
        }

    return [
        entry("ragged_attention_pool", "ragged_attention.cu",
              "ai_agent_kubectl_tpu/ops/ragged_attention.py:137",
              results.get("serve", {}).get("launches"),
              kernel.get("ragged_attention", {}).get("max_abs_err"),
              timing.get("ragged_attention", {}), "decode",
              "torch.nn.functional.scaled_dot_product_attention over the "
              "gathered contiguous view"),
        entry("flash_attention_cached", "flash_attention.cu",
              "ai_agent_kubectl_tpu/ops/flash_attention.py:123",
              serve1.get("flash_attention"),
              kernel.get("flash_attention", {}).get("max_abs_err"),
              timing.get("flash_attention", {}), "S512",
              "torch.nn.functional.scaled_dot_product_attention with the "
              "position mask"),
        entry("qmatmul4", "int4_matmul.cu",
              "ai_agent_kubectl_tpu/ops/quant4.py:293",
              serve1.get("int4_matmul"),
              kernel.get("int4_matmul", {}).get("max_abs_err"),
              timing.get("int4_matmul", {}), "w_gate_T1",
              "torch.matmul on the dequantized bf16 weight"),
        entry("paged_decode_attention_pool", "paged_attention.cu",
              "ai_agent_kubectl_tpu/ops/paged_attention.py:124",
              paged.get("pool", {}).get("launches", {}).get("paged"),
              kernel.get("paged_decode_attention_pool", {}).get(
                  "max_abs_err"),
              timing.get("paged_decode_attention_pool", {}), "decode",
              "torch.nn.functional.scaled_dot_product_attention over the "
              "gathered live span with a key mask"),
        entry("paged_decode_attention", "paged_attention.cu",
              "ai_agent_kubectl_tpu/ops/paged_attention.py:264",
              paged.get("dense", {}).get("launches", {}).get("paged"),
              kernel.get("paged_decode_attention", {}).get("max_abs_err"),
              dict(timing.get("paged_decode_attention", {}),
                   **({"ring_decode_tp2_s8192": ring_decode}
                      if ring_decode else {})), "decode",
              "torch.nn.functional.scaled_dot_product_attention over the "
              "live span with a key mask"),
        entry("ragged_attention_pool_sharded", "ragged_attention.cu",
              "ai_agent_kubectl_tpu/ops/ragged_attention.py:218",
              tp_launches("ragged_attention_pool_sharded"),
              kernel.get("ragged_attention_pool_sharded", {}).get(
                  "max_abs_err"),
              timing.get("ragged_attention_pool_sharded", {}), "decode",
              "torch.nn.functional.scaled_dot_product_attention over one "
              "shard's gathered contiguous view"),
        entry("paged_decode_attention_pool_sharded", "paged_attention.cu",
              "ai_agent_kubectl_tpu/ops/paged_attention.py:204",
              tp_launches("paged_decode_attention_pool_sharded"),
              kernel.get("paged_decode_attention_pool_sharded", {}).get(
                  "max_abs_err"),
              timing.get("paged_decode_attention_pool_sharded", {}),
              "decode",
              "torch.nn.functional.scaled_dot_product_attention over one "
              "shard's gathered live span with a key mask"),
    ]


# ------------------------------------------------------------ serve_obs

#: the served Gemma-2B with the telemetry plane on (serve_obs (a)); the
#: decode envelope of PERF_BASELINES is written by the phase.
SERVE_OBS_ENV = dict(SERVE_ENV, DEBUG_TOKEN="serve-obs-token",
                     LOG_FORMAT="json", SENTINEL_EVAL_SECS="0.5",
                     INCIDENT_PROFILE_SECS="1")
OBS_DEBUG_ROUTES = [("GET", "/debug/requests"), ("GET", "/debug/chunks"),
                    ("GET", "/debug/ledger"), ("GET", "/debug/incidents"),
                    ("GET", "/debug/requests/x"),
                    ("GET", "/debug/incidents/x"),
                    ("POST", "/debug/profile?seconds=0.1"),
                    ("POST", "/debug/trace?seconds=0.1")]
OBS_FAMILIES = {"goodput_steps", "goodput_ratio", "slo_burn_rate",
                "slo_error_budget_remaining", "slo_breaches",
                "step_time_seconds", "step_tokens_per_sec",
                "steptime_breach_trips", "incidents_captured",
                "incidents_suppressed", "engine_batch_occupancy",
                "engine_queue_depth", "engine_kv_pages_used",
                "engine_kv_pages_total", "decode_chunks",
                "chunk_fetch_seconds", "wasted_decode_steps",
                "decode_pipe_depth"}
#: kernel names of the GEMM libraries (cuBLAS, cuBLASLt, CUTLASS)
GEMM_NAME = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce",
                       re.IGNORECASE)
#: other_device may hold at most this share of the device's busy time
OTHER_DEVICE_MAX = 0.10


def phase_serve_obs(torch, serve_info: dict) -> dict:
    """Phase 10: (a) the telemetry plane served on Gemma-2B, (b) the
    offline attribution of Gemma-7B int4's decode chunk."""
    release_served_apps(torch)
    served = asyncio.run(_serve_obs(torch))
    if serve_info.get("burst_tok_per_s"):
        log(f"[serve_obs] burst tok/s: serve {serve_info['burst_tok_per_s']:.1f}"
            f" (every layer), serve_obs (a) {served['burst_tok_per_s']:.1f} "
            f"(telemetry on, PHASE_LAYERS; one burst each, no claim)")
    release_served_apps(torch)
    offline = _attribute_7b_int4(torch)
    return {"served": served, "offline": offline}


def _save_artifact(art: dict, name: str) -> str:
    """Write an attribution artifact under build/ (its ops' names whole)
    and return the compact one-line form the log carries (op names cut
    to 80 characters)."""
    path = ROOT / "build" / name
    path.write_text(json.dumps(art, indent=1))
    short = dict(art, categories=[
        dict(c, top_ops=[dict(o, name=o["name"][:80]) for o in c["top_ops"]])
        for c in art["categories"]])
    return f"{path.relative_to(ROOT)} " + json.dumps(short)


def _spans_by_category(trace_dir: str) -> list:
    """(category, op name, us) of every device span of a capture."""
    from ai_agent_kubectl_tpu_torch.obs import attribution as attr

    spans, source = attr._select_spans(attr._load_trace_events(trace_dir))
    if source != "cuda_device":
        raise AssertionError(f"capture {trace_dir}: span_source {source}, "
                             f"not cuda_device")
    return [(attr.categorize(text), op, te - ts)
            for ts, te, text, op in spans]


def _check_billing(spans, pattern, allowed: set, what: str) -> dict:
    hits = [(cat, us) for cat, op, us in spans if re.search(pattern, op)]
    if not hits:
        raise AssertionError(f"no {what} span in the capture")
    wrong = {cat for cat, _ in hits if cat not in allowed}
    if wrong:
        raise AssertionError(f"{what} spans billed to {sorted(wrong)}, "
                             f"not {sorted(allowed)}")
    return {"spans": len(hits), "us": sum(us for _, us in hits)}


async def _serve_obs(torch) -> dict:
    import io
    import logging

    import aiohttp
    from aiohttp import web
    from prometheus_client.parser import text_string_to_metric_families

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.logging_setup import setup_logging
    from ai_agent_kubectl_tpu_torch.obs import attribution as attr
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine

    base = ROOT / "build" / "serve_obs_baselines.json"
    base.parent.mkdir(parents=True, exist_ok=True)
    base.write_text(json.dumps({
        "source": "chip_smoke.py serve_obs: an envelope no card meets",
        "step_time_ms": {"decode": {"default": 0.01}}}))
    port = _free_port()
    _phase_env(dict(SERVE_OBS_ENV, PERF_BASELINES=str(base)), port)
    cfg = ServiceConfig.from_env()
    # The server's logging (LOG_FORMAT=json), its lines kept in memory.
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    setup_logging(cfg.log_level, cfg.log_format)
    lines = io.StringIO()
    root.handlers[0].setStream(lines)
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine):
        raise AssertionError(f"engine construction failed: {inner!r}")
    engine = RecordingEngine(inner)
    app = create_app(cfg, engine)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    url = f"http://{cfg.host}:{port}"
    dbg = {"X-Debug-Token": cfg.debug_token}
    out: dict = {}
    try:
        async with aiohttp.ClientSession() as http:
            for method, path in OBS_DEBUG_ROUTES:
                async with http.request(method, url + path) as r:
                    if r.status != 403:
                        raise AssertionError(f"{path} without the debug "
                                             f"token: {r.status}")

            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return (r.status, r.headers["X-Request-ID"],
                            await r.json())

            async def get(path):
                async with http.get(url + path, headers=dbg) as r:
                    return r.status, await r.json()

            delivered0 = inner.ledger_snapshot()["classes"]["delivered"]
            t0 = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            burst_s = time.monotonic() - t0
            out["burst_tok_per_s"] = sum(
                r.completion_tokens for _, r in engine.results) / burst_s
            repeats = [await ask(QUERIES[i]) for i in REPEATS]
            # The sentinel's decode digest breaches the 0.01 ms envelope;
            # the watcher files one steptime_breach bundle and attaches a
            # one-second capture to it.
            incident = None
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                _, listing = await get("/debug/incidents")
                found = [i for i in listing["incidents"]
                         if i["trigger"] == "steptime_breach"]
                if found:
                    _, incident = await get(
                        f"/debug/incidents/{found[0]['id']}")
                    if "profile" in incident:
                        break
                await asyncio.sleep(0.25)
            if incident is None or "trace_dir" not in incident.get(
                    "profile", {}):
                raise AssertionError(f"no steptime_breach bundle with a "
                                     f"trace: {incident}")
            # The second burst, captured while it decodes.
            second = [f"{q} (obs {k})" for k in (1, 2) for q in QUERIES]
            burst2 = asyncio.ensure_future(
                asyncio.gather(*[ask(q) for q in second]))
            await asyncio.sleep(0.5)
            async with http.post(f"{url}/debug/profile?seconds=2",
                                 headers=dbg) as r:
                profile = await r.json()
                if r.status != 200:
                    raise AssertionError(f"/debug/profile: {r.status} "
                                         f"{profile}")
            burst2 = await burst2
            await asyncio.sleep(1.0)            # a watcher pass or two
            answers = burst + repeats + burst2
            status, listing = await get("/debug/incidents")
            breaches = [i for i in listing["incidents"]
                        if i["trigger"] == "steptime_breach"]
            if (len(breaches) != 1 or listing["suppressed_total"].get(
                    "steptime_breach", 0) < 1):
                raise AssertionError(f"incidents: {listing}")
            _, reqs = await get("/debug/requests?limit=256")
            listed = {e["request_id"] for e in reqs["requests"]}
            missing = {rid for _, rid, _ in answers} - listed
            if missing:
                raise AssertionError(f"/debug/requests lacks {missing}")
            if (await get(f"/debug/requests/{answers[0][1]}"))[0] != 200 \
                    or (await get("/debug/requests/nope"))[0] != 404:
                raise AssertionError("/debug/requests detail statuses")
            _, chunks = await get("/debug/chunks?limit=100000")
            events = [e["event"] for e in chunks["events"]]
            pipe = chunks["pipeline"]
            if (events.count("dispatch") != pipe["chunks_dispatched"]
                    or events.count("consume") != pipe["chunks_consumed"]
                    or len(events) >= 512):
                raise AssertionError(f"/debug/chunks: {len(events)} events"
                                     f" against {pipe}")
            _, ledger = await get("/debug/ledger")
            tokens = [r.completion_tokens for _, r in engine.results]
            delivered = ledger["classes"]["delivered"] - delivered0
            if (not ledger["conservation"]["balanced"]
                    or delivered != sum(tokens)
                    or set(tokens) != {int(cfg.max_new_tokens)}):
                raise AssertionError(f"ledger: delivered {delivered} "
                                     f"against {sum(tokens)} ({tokens}); "
                                     f"{ledger['conservation']}")
            async with http.get(f"{url}/health") as r:
                health = await r.json()
            if not all(health.get(k) for k in ("slo", "steptime",
                                               "incidents")):
                raise AssertionError(f"/health: {health}")
            async with http.get(f"{url}/metrics") as r:
                families = {f.name for f in
                            text_string_to_metric_families(await r.text())}
            if OBS_FAMILIES - families:
                raise AssertionError(f"/metrics lacks "
                                     f"{OBS_FAMILIES - families}")
    finally:
        await runner.cleanup()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
    ids = {rid for _, rid, _ in answers}
    entries = [json.loads(x) for x in lines.getvalue().splitlines() if x]
    received = [e for e in entries
                if e["message"].startswith("Received query")]
    if (len(received) < len(answers)
            or any(e["request_id"] not in ids for e in received)):
        raise AssertionError(f"JSON log lines without their request id: "
                             f"{[e for e in received if e['request_id'] not in ids][:3]}")
    # The capture, attributed: its forward passes are its lm_head ranges.
    trace_dir = profile["trace_dir"]
    steps = sum(1 for e in attr._load_trace_events(trace_dir)
                if e.get("cat") == "user_annotation"
                and e.get("name") == "lm_head")
    art = attr.attribute_trace(trace_dir, max(steps, 1), meta={
        "model": cfg.model_name, "what": "serve_obs (a) /debug/profile"})
    attr.validate_attribution(art)
    spans = _spans_by_category(trace_dir)
    ragged = _check_billing(spans, r"ragged_(mma|combine)_kernel",
                            {"attention"}, "ragged kernel")
    gemms = _check_billing(spans, GEMM_NAME.pattern,
                           {"weight_gemms", "lm_head_sampling"}, "GEMM")
    cats = {c["name"]: c for c in art["categories"]}
    other_ms = cats["other_device"]["ms_per_step"] * art["steps_measured"]
    if (art["span_source"] != "cuda_device" or steps < 1
            or other_ms > OTHER_DEVICE_MAX * art["device_busy_ms_total"]
            or cats["weight_gemms"]["ms_per_step"] <= 0):
        raise AssertionError(f"attribution: "
                             f"{_save_artifact(art, 'serve_obs_a.json')}")
    log(f"[serve_obs] (a) {len(answers)} requests, {sum(tokens)} tokens "
        f"delivered, burst {out['burst_tok_per_s']:.1f} tok/s; incident "
        f"{incident['id']} ({incident['trigger']}) with trace "
        f"{incident['profile'].get('trace_dir')}; {len(entries)} JSON log "
        f"lines, {len(received)} per-request")
    log(f"[serve_obs] (a) /debug/profile: {steps} forward passes, "
        f"{art['n_device_spans']} device spans, device busy "
        f"{art['device_busy_ms_total']:.1f} of {art['wall_ms_total']:.1f} "
        f"ms; ragged {ragged}; GEMMs {gemms}")
    log("[serve_obs] (a) attribution table\n" + attr.render_markdown(art))
    log("[serve_obs] (a) json " + _save_artifact(art, "serve_obs_a.json"))
    out.update(attribution=art, forward_steps=steps, ragged=ragged,
               gemms=gemms, incident=incident["id"], log_lines=len(entries))
    return out


def _attribute_7b_int4(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.obs import attribution as attr

    t0 = time.monotonic()
    art = attr.run_attribution(model="gemma-7b-it", quant="int4",
                               batch_size=8, chunk_len=8, reps=4,
                               device="cuda", keep_trace=True)
    took = time.monotonic() - t0
    trace_dir = art.pop("trace_dir")
    try:
        attr.validate_attribution(art)
        if art["span_source"] != "cuda_device":
            raise AssertionError(f"(b) span_source {art['span_source']}")
        int4 = _check_billing(_spans_by_category(trace_dir),
                              r"int4_(mma|reduce)_kernel", {"weight_gemms"},
                              "int4 kernel")
    finally:
        import shutil

        shutil.rmtree(trace_dir, ignore_errors=True)
    log(f"[serve_obs] (b) gemma-7b-it int4 decode chunk in {took:.1f} s: "
        f"step {art['step_ms']:.3f} ms, device busy "
        f"{art['device_busy_ms_per_step']:.3f} ms a step, coverage "
        f"{art['coverage_pct']:.1f}%; int4 {int4}")
    log("[serve_obs] (b) attribution table\n" + attr.render_markdown(art))
    log("[serve_obs] (b) json " + _save_artifact(art, "serve_obs_b.json"))
    return {"attribution": art, "int4": int4, "seconds": took}


# ----------------------------------------------------------- serve_chaos

#: phase 11's server: serve's Gemma-2B cell with the factory's one fault
#: injector threaded into the batcher (armed with a nan drill at rate 0,
#: which never fires; each drill re-arms it), the response cache's TTL at
#: 1 ms so every drill's request reaches the engine, and the default
#: breaker.
CHAOS_ENV = dict(SERVE_ENV, FAULT_POINTS="decode:nan:0", CACHE_TTL="0.001")
#: the request every targeted drill poisons
CHAOS_TARGET = QUERIES[2]
CHAOS_TARGET_TEXT = "describe the deployment named web"
#: the one-shot drill NaNs the target's logits in the third chunk that
#: carries it: every slot has two chunks of tokens to replay
CHAOS_SKIP = 2
#: the poison_step drill's resets with 8 suspects and the target third:
#: the bisection's levels, the budgeted replay and the confirmation, as
#: the JAX engine counts them on the CPU for the same slot count and
#: target position (tests/test_torch_containment.py::
#: test_poison_step_bisection_of_eight_suspects_matches_jax)
CHAOS_POISON_RESETS = 8
#: (c): the watchdog's limit, set on the live engine after the warm
#: bursts; the in-flight requests must fail within the limit plus one
#: watchdog interval plus this much for HTTP and admission
CHAOS_WATCHDOG_SECS = 4.0
CHAOS_HANG_SLACK_S = 1.0
#: the peak device memory across a reset may exceed the fault-free
#: burst's peak by at most this share
CHAOS_PEAK_SLACK = 0.05


def phase_serve_chaos(torch) -> dict:
    """Phase 11: blast-radius containment drilled on Gemma-2B over HTTP:
    (a) the pool and ragged regime, (b) the dense ladder with paged
    decode, (c) a hung chunk on (b)'s server."""
    release_served_apps(torch)
    return asyncio.run(_serve_chaos(torch))


async def _serve_chaos(torch) -> dict:
    pool, params = await _chaos_server(torch, "pool", {}, None)
    release_served_apps(torch)
    dense, _ = await _chaos_server(
        torch, "dense", {"KV_POOL": "false", "DECODE_ATTN": "paged"}, params)
    return {"pool": pool, "dense": dense}


def _arm_nan_once(inj, target: str, skip: int = CHAOS_SKIP) -> None:
    """``decode:nan`` on ``target``, once: the (skip+1)-th dispatch that
    carries it NaNs its logits on the card, then the point disarms."""
    seen = {"n": 0}
    orig = type(inj).decode_nan_slots.__get__(inj)

    def once(prompts, replica=None):
        hits = orig(prompts, replica)
        if not hits:
            return hits
        seen["n"] += 1
        if seen["n"] <= skip:
            return []
        inj.release("decode")
        return hits

    inj.decode_nan_slots = once
    inj.target_substr = target
    inj.set("decode", "nan")


#: the counters of /metrics that serve_chaos and serve_grammar read
CONTAINMENT_FAMILIES = ("engine_resets_total", "quarantined_requests_total",
                        "replayed_tokens_total", "slot_health_trips_total")
GRAMMAR_FAMILIES = ("grammar_forced_tokens_total",
                    "grammar_masked_steps_total", "grammar_dead_end_total")


def _scrape(text: str, names=CONTAINMENT_FAMILIES) -> dict:
    """The samples of ``names`` in a /metrics body, keyed by name and
    labels."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name in names:
                key = s.name + "".join(f"{{{k}={v}}}"
                                       for k, v in sorted(s.labels.items()))
                out[key] = s.value
    return out


async def _chaos_server(torch, kind: str, env: dict, params):
    """One engine of phase 11 behind the HTTP app: the fault-free burst,
    then each drill's burst, every gate checked after its drill."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.quant4 import qmatmul4
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text
    from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

    tag = f"serve_chaos/{kind}"
    port = _free_port()
    _phase_env({**CHAOS_ENV, **env}, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if (not isinstance(inner, BatchedTorchEngine)
            or not isinstance(inner.faults, FaultInjector)):
        raise AssertionError(f"{tag}: engine construction failed, or no "
                             f"injector threaded in: {inner!r}")
    if params is not None:
        inner.params = params
    inj = inner.faults
    engine = RecordingEngine(inner)
    # Seams the gates read: each trip (a containment pass's start, or the
    # scheduler's death) and the first chunk consumed after it without
    # another trip; each replay's flash launches.
    trips: list = []
    contain, consume = inner._contain_poisoned_step, inner._consume_oldest
    replay, die = inner._replay_slot, inj.check_scheduler_die
    replay_flash: list = []

    def on_contain(cause, named=(), error=None):
        trips.append({"t": time.monotonic(), "cause": cause, "first": None})
        contain(cause, named=named, error=error)

    def on_consume():
        n = len(trips)
        consume()
        if n and len(trips) == n and trips[-1]["first"] is None:
            trips[-1]["first"] = time.monotonic()

    def on_replay(slot):
        n0 = flash_attention_cached.launches
        replay(slot)
        replay_flash.append(flash_attention_cached.launches - n0)

    def on_die(*a):
        try:
            die(*a)
        except BaseException:
            trips.append({"t": time.monotonic(), "cause": "scheduler_death",
                          "first": None})
            raise

    inner._contain_poisoned_step, inner._consume_oldest = on_contain, \
        on_consume
    inner._replay_slot, inj.check_scheduler_die = on_replay, on_die
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    log(f"[{tag}] {cfg.model_name} up in {time.monotonic() - t0:.1f} s "
        f"({inner.batch_size} slots, regime {inner._attention_regime}, "
        f"decode {inner._decode_impl}; retry budget "
        f"{inner.supervisor.retry_budget}, {cfg.engine_reset_max_per_min} "
        f"resets a minute, breaker threshold {cfg.breaker_threshold})")
    url = f"http://{cfg.host}:{port}"
    # Every kernel's count is zeroed before the fault-free burst and read
    # after the last drill, so the kernels line's serve_chaos counts are
    # all measured (0 for a kernel this phase never reaches).
    counters = (ragged_attention_pool, flash_attention_cached,
                paged_decode_attention, paged_decode_attention_pool,
                qmatmul4)
    target_ids = inner.tokenizer.encode(render_prompt(CHAOS_TARGET))
    info: dict = {"drills": {}}
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            async def scrape():
                async with http.get(f"{url}/metrics") as r:
                    return _scrape(await r.text())

            async def health():
                async with http.get(f"{url}/health") as r:
                    return r.status, await r.json()

            async def burst(queries=QUERIES, busy_then=None):
                """The queries at once; ``busy_then`` arms a drill once
                every slot decodes. Returns (answers, results, seconds)."""
                engine.results.clear()
                t = time.monotonic()
                task = asyncio.ensure_future(
                    asyncio.gather(*[ask(q) for q in queries]))
                if busy_then is not None:
                    await _wait_slots(inner, len(queries), 1)
                    busy_then()
                answers = await task
                took = time.monotonic() - t
                results = {p: r for p, r in engine.results}
                return answers, results, took

            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ref_answers, ref, ref_s = await burst()
            torch.cuda.synchronize()
            steady_peak = torch.cuda.max_memory_allocated()
            ref_tokens = sum(r.completion_tokens for r in ref.values())
            _chaos_statuses(tag, "reference", ref_answers, ref,
                            status_for_text, render_prompt)
            info["reference"] = {"burst_s": ref_s,
                                 "burst_tok_per_s": ref_tokens / ref_s}
            log(f"[{tag}] fault-free burst: {ref_tokens} tokens in "
                f"{ref_s:.2f} s ({ref_tokens / ref_s:.1f} tok/s)")

            async def drill(name, arm=None, busy_then=None, quarantine=False):
                stats0 = inner.supervisor.stats()
                n_trips = len(trips)
                if arm is not None:
                    arm()
                answers, results, took = await burst(busy_then=busy_then)
                inj.clear()
                inj.__dict__.pop("decode_nan_slots", None)
                inj.target_substr = None
                stats1 = inner.supervisor.stats()
                d = {k: {c: n - stats0[k].get(c, 0)
                         for c, n in stats1[k].items()
                         if n != stats0[k].get(c, 0)}
                     for k in ("resets", "quarantined")}
                for k in ("health_trips", "replayed_tokens"):
                    d[k] = stats1[k] - stats0[k]
                new = trips[n_trips:]
                latency = [round((t["first"] - t["t"]) * 1e3, 3)
                           for t in new if t["first"] is not None]
                ok = _chaos_statuses(tag, name, answers, results,
                                     status_for_text, render_prompt,
                                     quarantined=(CHAOS_TARGET
                                                  if quarantine else None))
                mismatches = []
                for q in ok:
                    prompt = render_prompt(q)
                    miss = _first_mismatch(
                        torch, inner, inner.tokenizer.encode(prompt),
                        ref[prompt].token_ids, results[prompt].token_ids,
                        0.0, 0)
                    if miss is not None:
                        mismatches.append(dict(miss, query=q))
                        if miss["gap"] > miss["tolerance"]:
                            raise AssertionError(
                                f"{tag} {name}: {q!r} left its fault-free "
                                f"transcript away from a near tie: {miss}")
                n_tok = sum(r.completion_tokens for r in results.values())
                out = {"delta": d, "trip_to_first_replayed_ms": latency,
                       "causes": [t["cause"] for t in new],
                       "burst_s": took, "burst_tok_per_s": n_tok / took,
                       "near_tie_mismatches": mismatches}
                info["drills"][name] = out
                log(f"[{tag}] {name}: {d}; trip to first replayed token "
                    f"{latency} ms; burst {n_tok} tokens in {took:.2f} s "
                    f"({n_tok / took:.1f} tok/s); "
                    f"{len(mismatches)} near-tie mismatches")
                return out

            # One-shot decode:nan at budget 1: replayed, nothing lost.
            kv_bytes = sum(t.numel() * t.element_size()
                           for t in (inner._cache.k, inner._cache.v))
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one = await drill("nan_once", lambda: _arm_nan_once(
                inj, CHAOS_TARGET_TEXT))
            torch.cuda.synchronize()
            reset_peak = torch.cuda.max_memory_allocated()
            info["memory"] = {"allocated_before_bytes": mem0,
                              "steady_peak_bytes": steady_peak,
                              "reset_peak_bytes": reset_peak,
                              "kv_bytes": kv_bytes,
                              "ratio": reset_peak / steady_peak}
            log(f"[{tag}] device memory: {mem0 / 1e9:.3f} GB allocated "
                f"before the drill, peak {steady_peak / 1e9:.3f} GB over "
                f"the fault-free burst, {reset_peak / 1e9:.3f} GB across "
                f"the reset ({reset_peak / steady_peak:.4f}x; the KV "
                f"{'pool' if kind == 'pool' else 'cache'} is "
                f"{kv_bytes / 1e9:.3f} GB); {gpu_line()}")
            # At most 5 % over steady state, and never a second KV pool
            # or cache resident beside the first (the 5 % alone would
            # let Gemma-2B's 0.15 GB pool through twice).
            if (reset_peak > (1 + CHAOS_PEAK_SLACK) * steady_peak
                    or reset_peak - steady_peak >= kv_bytes / 2):
                raise AssertionError(
                    f"{tag}: a reset's peak {reset_peak} B against the "
                    f"fault-free burst's {steady_peak} B (limit "
                    f"{CHAOS_PEAK_SLACK:.0%} over, and less than half the "
                    f"{kv_bytes} B of KV more)")
            m = await scrape()
            _, h = await health()
            if (one["delta"]["resets"] != {"slot_health": 1}
                    or one["delta"]["quarantined"]
                    or m.get("engine_resets_total{cause=slot_health}") != 1
                    or m.get("slot_health_trips_total") != 1
                    or h.get("last_reset_cause") != "slot_health"
                    or not h.get("last_reset")):
                raise AssertionError(f"{tag} nan_once: {one['delta']}, "
                                     f"/metrics {m}, /health {h}")
            if kind == "dense":
                if not replay_flash or min(replay_flash) < \
                        inner.model_cfg.n_layers:
                    raise AssertionError(f"{tag}: a replay did not prefill "
                                         f"through flash: {replay_flash}")
            else:
                # Persistent decode:nan on one request: 410 after 2 trips.
                two = await drill("nan_persistent", lambda: (
                    setattr(inj, "target_substr", CHAOS_TARGET_TEXT),
                    inj.set("decode", "nan")), quarantine=True)
                m = await scrape()
                if (two["delta"]["resets"] != {"slot_health": 2}
                        or two["delta"]["quarantined"] != {"slot_health": 1}
                        or m.get("quarantined_requests_total"
                                 "{reason=slot_health}") != 1):
                    raise AssertionError(f"{tag} nan_persistent: "
                                         f"{two['delta']}, /metrics {m}")
                # scheduler:die once every slot decodes: zero dropped.
                die_ = await drill("scheduler_die", busy_then=lambda:
                                   inj.set("scheduler", "die"))
                if die_["delta"]["resets"] != {"scheduler_death": 1}:
                    raise AssertionError(f"{tag} scheduler_die: "
                                         f"{die_['delta']}")
                # Persistent decode:poison_step on one request, last: its
                # resets are the breaker's fifth failure in the window.
                three = await drill("poison_step", lambda: (
                    setattr(inj, "target_substr", CHAOS_TARGET_TEXT),
                    inj.set("decode", "poison_step")), quarantine=True)
                if (inner.batch_size != 8
                        or three["delta"]["resets"]
                        != {"scheduler_error": CHAOS_POISON_RESETS}
                        or three["delta"]["quarantined"]
                        != {"step_poison": 1}):
                    raise AssertionError(f"{tag} poison_step: "
                                         f"{three['delta']} (the JAX "
                                         f"engine's {CHAOS_POISON_RESETS} "
                                         f"resets for 8 slots)")
                _, h = await health()
                info["breaker_after_poison_step"] = h["breaker"]
                log(f"[{tag}] breaker after the poison_step drill: "
                    f"{h['breaker']} (each reset is a breaker failure)")
            info["launches"] = {fn.__name__: fn.launches for fn in counters}
            if kind == "pool" and info["launches"][
                    "ragged_attention_pool"] <= 0:
                raise AssertionError(f"{tag}: no ragged launch")
            if kind == "dense" and (
                    info["launches"]["flash_attention_cached"] <= 0
                    or info["launches"]["paged_decode_attention"] <= 0):
                raise AssertionError(f"{tag}: launches {info['launches']}")
            log(f"[{tag}] launches: {info['launches']}; replay flash "
                f"launches {replay_flash[:8]}")
            if kind == "dense":
                info["hang"] = await _chaos_hang(
                    tag, inner, inj, ask, health, burst, status_for_text,
                    render_prompt)
    finally:
        await runner.cleanup()           # drains and stops the engine
    if kind == "pool":
        check_pool_books(inner)
    return info, inner.params


def _chaos_statuses(tag, name, answers, results, status_for_text,
                    render_prompt, quarantined=None) -> list:
    """Every answer as the service decides for the engine's text, the
    quarantined query's 410 excepted. Returns the served queries."""
    ok = []
    for q, (status, body) in zip(QUERIES, answers):
        if q == quarantined:
            if status != 410 or "quarantined" not in body.get("detail", ""):
                raise AssertionError(f"{tag} {name}: the poisoned request "
                                     f"answered {status}: {body}")
            continue
        res = results.get(render_prompt(q))
        if res is None:
            raise AssertionError(f"{tag} {name}: {q!r} answered {status} "
                                 f"without an engine result: {body}")
        want = status_for_text(res.text)
        if status != want:
            raise AssertionError(f"{tag} {name}: {q!r} HTTP {status}, the "
                                 f"service gives {want}: {body}")
        ok.append(q)
    return ok


async def _chaos_hang(tag, inner, inj, ask, health, burst, status_for_text,
                      render_prompt) -> dict:
    """(c): after the warm bursts the watchdog's limit drops to
    CHAOS_WATCHDOG_SECS on the live engine, and chunk:hang blocks the
    scheduler in a dispatch. Two requests in flight fail with 503 within
    the limit plus one interval; /health turns not ready; after release
    the engine is ready again and a fresh burst is served."""
    inner.watchdog_secs = CHAOS_WATCHDOG_SECS
    interval = max(1.0, CHAOS_WATCHDOG_SECS / 4.0)
    inj.set("chunk", "hang", 120.0)
    t0 = time.monotonic()

    async def timed(q):
        status, body = await ask(q)
        return status, time.monotonic() - t0, body

    hung = await asyncio.gather(*[timed(f"{q} while hung")
                                  for q in QUERIES[:2]])
    limit_s = CHAOS_WATCHDOG_SECS + interval + CHAOS_HANG_SLACK_S
    h_status, h = await health()
    inj.release("chunk")
    t_rel = time.monotonic()
    while time.monotonic() - t_rel < 30.0:
        r_status, _ = await health()
        if r_status == 200:
            break
        await asyncio.sleep(0.1)
    ready_s = time.monotonic() - t_rel
    answers, results, took = await burst(
        queries=[f"{q} after the hang" for q in QUERIES])
    for q, (status, body) in zip([f"{q} after the hang" for q in QUERIES],
                                 answers):
        res = results.get(render_prompt(q))
        if res is None or status != status_for_text(res.text):
            raise AssertionError(f"{tag} hang: {q!r} after release "
                                 f"answered {status}: {body}")
    f_status, f = await health()
    out = {"failed": [(s, round(t, 3)) for s, t, _ in hung],
           "limit_s": limit_s, "health_while_hung": h_status,
           "ready_after_release_s": ready_s, "health_after": f_status,
           "breaker_after": f["breaker"]}
    log(f"[{tag}] chunk:hang at a {CHAOS_WATCHDOG_SECS:.0f} s watchdog: "
        f"{out['failed']} (limit {limit_s:.1f} s), /health {h_status} while "
        f"hung, ready {ready_s:.2f} s after release, then a burst of "
        f"{len(answers)} served in {took:.2f} s; /health {f_status} "
        f"(breaker {f['breaker']})")
    if (any(s != 503 or t > limit_s for s, t, _ in hung)
            or h_status != 503 or h.get("engine_ready")
            or r_status != 200 or f_status != 200):
        raise AssertionError(f"{tag} hang: {out}")
    return out


# --------------------------------------------------------- serve_grammar

#: the served Gemma-2B with grammar-constrained decoding on (phase 12
#: (a)): the BPE asset, the default profile, one background tenant key
GRAMMAR_BG_KEY = "grammar-bg-key"
GRAMMAR_ENV = dict(SERVE_ENV, GRAMMAR_DECODE="true", GRAMMAR_PROFILE="default",
                   TENANT_TIERS=f"{GRAMMAR_BG_KEY}:background")
#: the burst's grammar headers, by query index (the rest send none)
GRAMMAR_HEADERS = {0: {"X-Grammar-Profile": "readonly"},
                   1: {"X-Grammar-Profile": "readonly"},
                   2: {"X-Allowed-Verbs": "get,describe"},
                   3: {"X-API-Key": GRAMMAR_BG_KEY}}
#: (b): prompts served one at a time, each greedy and at 0.9
GRAMMAR_FF_PROMPTS = ["list all pods", "scale web", "show nodes",
                      "delete the job"]
GRAMMAR_FF_TOKENS = 40
GRAMMAR_FF_CHUNK = 4


def phase_serve_grammar(torch, serve_info: dict) -> dict:
    """Phase 12: grammar-constrained decoding on Gemma-2B: (a) over HTTP
    with the BPE asset, (b) at the engine with ByteTokenizer, where
    forced runs are long."""
    release_served_apps(torch)
    return asyncio.run(_serve_grammar(torch, serve_info))


def _launch_counters():
    """Every kernel wrapper's launch counter, by name (the port's)."""
    from ai_agent_kubectl_tpu_torch.ops._cuda import launch_counters

    return launch_counters()


async def _serve_grammar(torch, serve_info: dict) -> dict:
    a, served = await _grammar_http(torch, serve_info)
    release_served_apps(torch)
    b = await _grammar_forced_runs(torch, served)
    counters = _launch_counters()
    return {"http": a, "forced_runs": b,
            "launches": {n: a["launches"][n] + b["launches"][n]
                         for n in counters}}


async def _grammar_http(torch, serve_info: dict):
    """(a): the serve burst over HTTP with the grammar on, two queries
    lowered to readonly, one narrowed to get/describe, one from the
    background tenant (clamped readonly), and a 400 for an unknown verb.
    Returns (info, the engine's parameters)."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.constrain import (READONLY_VERBS,
                                                      GrammarContext)
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.safety import unsafe_reason
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = "serve_grammar/http"
    port = _free_port()
    _phase_env(GRAMMAR_ENV, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine) or not inner.grammar_decode:
        raise AssertionError(f"{tag}: engine construction failed: {inner!r}")
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    g = inner._grammar
    gh = g.health()
    log(f"[{tag}] {cfg.model_name} up in {time.monotonic() - t0:.1f} s "
        f"(regime {inner._attention_regime}); grammar {gh['grammar_hash']}: "
        f"{gh['states']} states, {gh['classes']} classes, "
        f"{int(g.tok_class.nbytes + g.class_ok.nbytes + g.class_next.nbytes)}"
        f" table bytes; START admits "
        f"{int(g.allowed_np(g.start_state(0)).sum())} tokens")
    url = f"http://{cfg.host}:{port}"
    counters = _launch_counters()
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query, headers):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query},
                                     headers=headers) as r:
                    return r.status, await r.json()

            engine.results.clear()
            h0 = inner.grammar_health()
            for fn in counters.values():
                fn.launches = 0
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[
                ask(q, GRAMMAR_HEADERS.get(i, {}))
                for i, q in enumerate(QUERIES)])
            burst_s = time.monotonic() - t_burst
            steps = inner.forward_steps - steps0
            # The same burst again, fresh queries: every variant is
            # compiled now, so this one times the mask alone.
            steps1 = inner.forward_steps
            t_again = time.monotonic()
            again = await asyncio.gather(*[
                ask(f"{q} again", GRAMMAR_HEADERS.get(i, {}))
                for i, q in enumerate(QUERIES)])
            again_s = time.monotonic() - t_again
            again_steps = inner.forward_steps - steps1
            bad = await ask("list the pods",
                            {"X-Allowed-Verbs": "get,frobnicate"})
            launches = {n: fn.launches for n, fn in counters.items()}
            async with http.get(f"{url}/health") as r:
                health = (await r.json())["grammar"]
            async with http.get(f"{url}/metrics") as r:
                families = _scrape(await r.text(), GRAMMAR_FAMILIES)
    finally:
        await runner.cleanup()           # drains and stops the engine

    if bad[0] != 400 or "frobnicate" not in bad[1].get("detail", ""):
        raise AssertionError(f"{tag}: an unknown verb answered {bad}")
    results = {p: r for p, r in engine.results}
    # Each query's profile, resolved as the engine resolved it (every
    # variant is installed by now), and the verbs it may start with.
    readonly = set(READONLY_VERBS)
    plan = []
    for i, q in enumerate(QUERIES):
        hdr = GRAMMAR_HEADERS.get(i, {})
        if "X-Allowed-Verbs" in hdr:
            verbs = {"get", "describe"}
            pid = g.resolve(ctx=GrammarContext(allowed_verbs=frozenset(
                verbs)))
        elif hdr:
            verbs = readonly
            pid = g.resolve(lane="background" if "X-API-Key" in hdr
                            else None,
                            ctx=GrammarContext(profile="readonly"
                                               if "X-API-Key" not in hdr
                                               else None))
        else:
            verbs, pid = None, g.resolve()
        plan.append((q, pid, verbs))
    per_query = []
    sent = [(q, pid, verbs, answer)
            for suffix, answers in (("", burst), (" again", again))
            for (q, pid, verbs), answer in zip(
                [(q + suffix, pid, verbs) for q, pid, verbs in plan],
                answers)]
    for q, pid, verbs, (status, body) in sent:
        res = results.get(render_prompt(q))
        if res is None:
            raise AssertionError(f"{tag}: {q!r} answered {status} without "
                                 f"an engine result: {body}")
        text = res.text
        if not g.in_grammar(pid, res.token_ids):
            raise AssertionError(f"{tag}: {q!r} left profile {pid}'s "
                                 f"grammar: {text!r}")
        if unsafe_reason(text) is not None:
            raise AssertionError(f"{tag}: {q!r} is unsafe: {text!r} "
                                 f"({unsafe_reason(text)})")
        words = text.split()
        if verbs is not None and len(words) > 1:
            verb = words[1]
            whole = len(words) > 2 or text.endswith(" ") or \
                res.finish_reason == "stop"
            if (verb not in verbs if whole
                    else not any(v.startswith(verb) for v in verbs)):
                raise AssertionError(f"{tag}: {q!r} (profile {pid}) starts "
                                     f"with verb {verb!r}: {text!r}")
        want = status_for_text(text)
        if status != want:
            raise AssertionError(f"{tag}: {q!r} HTTP {status}, the service "
                                 f"gives {want} for {text!r}: {body}")
        per_query.append({"query": q, "pid": pid, "status": status,
                          "text": text[:80], "tokens": res.completion_tokens,
                          "finish": res.finish_reason})
    n_tok = sum(r["tokens"] for r in per_query[:len(QUERIES)])
    again_tok = sum(r["tokens"] for r in per_query[len(QUERIES):])
    forced = health["forced_tokens_total"] - h0["forced_tokens_total"]
    masked = health["masked_steps_total"] - h0["masked_steps_total"]
    n_all = n_tok + again_tok
    if masked + forced != n_all or masked < n_all - forced:
        raise AssertionError(f"{tag}: {masked} masked + {forced} forced "
                             f"tokens for {n_all} generated")
    want_fam = {"grammar_forced_tokens_total": health["forced_tokens_total"],
                "grammar_masked_steps_total": health["masked_steps_total"]}
    for cause, n in health["dead_ends_total"].items():
        want_fam[f"grammar_dead_end_total{{cause={cause}}}"] = n
    if {k: families.get(k) for k in want_fam} != {
            k: float(v) for k, v in want_fam.items()}:
        raise AssertionError(f"{tag}: /metrics {families} against /health "
                             f"{health}")
    n_layers = inner.model_cfg.n_layers
    if launches["ragged_attention_pool"] < n_layers * steps or steps <= 0:
        raise AssertionError(f"{tag}: ragged launched "
                             f"{launches['ragged_attention_pool']} times for "
                             f"{steps} forward steps")
    check_pool_books(inner)
    fold = _grammar_fold_cost(torch, inner)
    info = {"burst_s": burst_s, "burst_tokens": n_tok,
            "burst_tok_per_s": n_tok / burst_s, "forward_steps": steps,
            "ms_per_step": burst_s * 1e3 / steps,
            "again_s": again_s, "again_tokens": again_tok,
            "again_tok_per_s": again_tok / again_s,
            "again_forward_steps": again_steps,
            "again_ms_per_step": again_s * 1e3 / again_steps,
            "forced": forced, "masked": masked, "launches": launches,
            "queries": per_query, "fold": fold,
            "grammar": {k: gh[k] for k in ("grammar_hash", "states",
                                          "classes")},
            "statuses": [s for s, _ in burst] + [s for s, _ in again]
            + [bad[0]]}
    off = serve_info or {}
    off_ms = (off["burst_s"] * 1e3 / off["burst_forward_steps"]
              if off.get("burst_forward_steps") else None)
    log(f"[{tag}] statuses {info['statuses']}; {n_tok} + {again_tok} "
        f"tokens ({masked} masked, {forced} forced); first burst (the "
        f"allowed-verbs variant compiles) {burst_s:.2f} s, "
        f"{info['burst_tok_per_s']:.1f} tok/s, {info['ms_per_step']:.2f} ms "
        f"a forward step; again {again_s:.2f} s, "
        f"{info['again_tok_per_s']:.1f} tok/s, "
        f"{info['again_ms_per_step']:.2f} ms a forward step; the serve "
        f"phase's burst with the grammar off, every layer: "
        + (f"{off['burst_tok_per_s']:.1f} tok/s, {off_ms:.2f} ms a forward "
           f"step" if off_ms else "not run") + f"; {gpu_line()}")
    for row in per_query:
        log(f"[{tag}]   pid {row['pid']} {row['status']} {row['tokens']:3d} "
            f"tok {row['finish']:6s} {row['text']!r}")
    info["grammar_off_serve"] = {"burst_tok_per_s": off.get(
        "burst_tok_per_s"), "ms_per_step": off_ms}
    return info, (inner.params, cfg.model_name, cfg.dtype, cfg.torch_device)


def _grammar_fold_cost(torch, inner, iters: int = 200) -> dict:
    """One decode step's fold at the served shapes (8 slots, the model's
    vocabulary), with the grammar (the mask gathered through the stacked
    tables, the dead-end freeze, the masked argmax, the FSM advance) and
    without it, same inputs: ms a step on the host clock (each loop
    synchronized at its end) and between CUDA events (the device waits
    on the host's launches, so the two agree), then the device's busy ms
    and kernels a step under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from ai_agent_kubectl_tpu_torch.engine.batcher import step_fold

    dev, N = inner.device, inner.batch_size
    g = inner._grammar
    V = inner.model_cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((N, V), generator=gen, device=dev)
    tc_all, ok_d, nx_d = inner._grammar_tables_d()
    gs = torch.full((N,), g.start_state(0), dtype=torch.int64, device=dev)
    rows = tc_all[torch.div(gs, g.S_max, rounding_mode="floor")]
    prev = torch.zeros((N,), dtype=torch.int32, device=dev)
    ngen = torch.zeros((N,), dtype=torch.int32, device=dev)
    budget = torch.full((N,), 1 << 20, dtype=torch.int32, device=dev)
    live = torch.ones((N,), dtype=torch.bool, device=dev)
    out = {}
    for name, gram in (("off", None), ("on", (gs, rows, ok_d, nx_d))):
        def step():
            return step_fold(logits, prev, live, ngen, budget,
                             torch.zeros_like(ngen), gram, inner._sample,
                             inner._eos_d, V, True)
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        e0.record()
        for _ in range(iters):
            step()
        e1.record()
        torch.cuda.synchronize()
        out[name] = {"host_ms": (time.monotonic() - t0) * 1e3 / iters,
                     "event_ms": e0.elapsed_time(e1) / iters}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters // 4):
                step()
            torch.cuda.synchronize()
        busy_us = calls = 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            busy_us += float(dev_us)
            calls += int(e.count)
        out[name]["busy_ms"] = busy_us / 1e3 / (iters // 4)
        out[name]["kernels"] = calls / (iters // 4)
    log(f"[serve_grammar/fold] a step's fold, {N} slots x {V}, ms host / "
        f"between events / device busy, kernels: off "
        + " / ".join(f"{out['off'][k]:.4f}" for k in ("host_ms", "event_ms",
                                                       "busy_ms"))
        + f", {out['off']['kernels']:.0f}; on "
        + " / ".join(f"{out['on'][k]:.4f}" for k in ("host_ms", "event_ms",
                                                      "busy_ms"))
        + f", {out['on']['kernels']:.0f}; {gpu_line()}")
    return out


async def _grammar_forced_runs(torch, served) -> dict:
    """(b): the same model and regime at the engine with ByteTokenizer
    (``kubectl `` is an 8-token forced run from START), requests one at a
    time, greedy and at 0.9: fast-forward on (GRAMMAR_FORCED_RUN_MIN=4)
    against off (10**6), and the permissive profile against the grammar
    off. The model's EOS ids become the tokenizer's (id 2): Gemma's 107
    is the byte 'h' under ByteTokenizer, and an 'h' that could only end
    a command would dead-end every word that spells one."""
    import dataclasses

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import ByteTokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config

    tag = "serve_grammar/forced"
    params, model_name, dtype, device = served
    cfg = dataclasses.replace(get_config(model_name),
                              eos_ids=ByteTokenizer().eos_ids)
    counters = _launch_counters()
    ragged = counters["ragged_attention_pool"]
    reqs = [(p, t, 1000 + i) for i, p in enumerate(GRAMMAR_FF_PROMPTS)
            for t in (0.0, 0.9)]

    async def run(name, **kw):
        eng = BatchedTorchEngine(
            cfg, tokenizer=ByteTokenizer(), params=params,
            device=device, dtype=dtype,
            batch_size=N_SLOTS, chunk_len=GRAMMAR_FF_CHUNK, **kw)
        await eng.start()
        splice_launches = []
        ff = eng._grammar_fast_forward

        def recording(idx, slot):
            n0, s0 = ragged.launches, eng._grammar_ff_splices
            ff(idx, slot)
            if eng._grammar_ff_splices > s0:
                splice_launches.append(ragged.launches - n0)

        eng._grammar_fast_forward = recording
        out = {"results": [], "per_request": []}
        try:
            for fn in counters.values():
                fn.launches = 0
            start = eng.grammar_health()
            t0 = time.monotonic()
            for p, t, s in reqs:
                h0 = eng.grammar_health()
                r = await eng.generate(p, max_tokens=GRAMMAR_FF_TOKENS,
                                       temperature=t, seed=s)
                h1 = eng.grammar_health()
                out["results"].append(r)
                if h1 is not None:
                    out["per_request"].append({
                        k: h1[k] - h0[k] for k in (
                            "forced_tokens_total", "masked_steps_total",
                            "fast_forward_splices_total")})
            out["seconds"] = time.monotonic() - t0
            out["launches"] = {n: fn.launches for n, fn in counters.items()}
            # The traffic's totals (start()'s warm-up decodes too).
            end = eng.grammar_health()
            out["health"] = end and {
                k: end[k] - start[k] for k in (
                    "forced_tokens_total", "masked_steps_total",
                    "fast_forward_splices_total")}
            if end is not None:
                out["health"]["dead_ends_total"] = end["dead_ends_total"]
            out["splice_launches"] = splice_launches
            out["engine"] = eng
            if eng.kv_pool:
                check_pool_books(eng)
        finally:
            await eng.stop()
        n_tok = sum(r.completion_tokens for r in out["results"])
        log(f"[{tag}] {name}: {n_tok} tokens in {out['seconds']:.2f} s; "
            + (f"{out['health']['forced_tokens_total']} forced in "
               f"{out['health']['fast_forward_splices_total']} splices, "
               f"{out['health']['masked_steps_total']} masked; "
               if out["health"] else "")
            + f"ragged launches {out['launches']['ragged_attention_pool']}")
        return out

    runs = {}
    for name, kw in (("on", dict(grammar_decode=True,
                                 grammar_forced_run_min=4)),
                     ("off", dict(grammar_decode=True,
                                  grammar_forced_run_min=10 ** 6)),
                     ("permissive", dict(grammar_decode=True,
                                         grammar_profile="permissive")),
                     ("grammar_off", dict(grammar_decode=False))):
        runs[name] = await run(name, **kw)
        release_served_apps(torch)

    def compare(a, b, what, grammar):
        eng = runs[a]["engine"]
        out = []
        for (p, t, s), ra, rb in zip(reqs, runs[a]["results"],
                                     runs[b]["results"]):
            ids = eng.tokenizer.encode(p)
            allowed = None
            if grammar:
                want = list(ra.token_ids)
                got = list(rb.token_ids)
                k = next((i for i, (x, y) in enumerate(zip(want, got))
                          if x != y), None)
                if k is not None:
                    allowed = eng._grammar.allowed_np(
                        eng._grammar.run(0, want[:k]))
            miss = _first_mismatch(torch, eng, ids, ra.token_ids,
                                   rb.token_ids, t, s, allowed=allowed)
            if miss is not None:
                out.append(dict(miss, prompt=p, temperature=t))
                if miss["gap"] > miss["tolerance"]:
                    raise AssertionError(f"{tag}: {what}: {p!r} at {t} "
                                         f"parts away from a near tie: "
                                         f"{miss}")
        return out

    on, off = runs["on"], runs["off"]
    g = on["engine"]._grammar
    for r in on["results"] + off["results"]:
        if not g.in_grammar(0, r.token_ids):
            raise AssertionError(f"{tag}: off-grammar transcript "
                                 f"{r.text!r}")
    short = [d for d in on["per_request"]
             if d["forced_tokens_total"] < 8
             or d["fast_forward_splices_total"] < 1]
    if short:
        raise AssertionError(f"{tag}: requests without an admission splice "
                             f"of 8 tokens: {short}")
    if off["health"]["fast_forward_splices_total"] != 0:
        raise AssertionError(f"{tag}: the off run spliced")
    m_on, m_off = (on["health"]["masked_steps_total"],
                   off["health"]["masked_steps_total"])
    if not m_on < m_off:
        raise AssertionError(f"{tag}: masked steps on {m_on} not below off "
                             f"{m_off}")
    n_layers = on["engine"].model_cfg.n_layers
    mid = on["splice_launches"]
    if any(n < n_layers for n in mid):
        raise AssertionError(f"{tag}: a mid-stream splice launched the "
                             f"ragged kernel {mid} times")
    if on["launches"]["ragged_attention_pool"] <= 0:
        raise AssertionError(f"{tag}: no ragged launch")
    near_ff = compare("on", "off", "fast-forward on vs off", True)
    near_perm = compare("grammar_off", "permissive", "permissive vs off",
                        False)
    info = {
        "requests": len(reqs),
        "per_request_on": on["per_request"],
        "mid_stream_splices": len(mid),
        "mid_stream_splice_launches": mid,
        "near_tie_mismatches": {"ff": near_ff, "permissive": near_perm},
        "launches": {n: sum(runs[k]["launches"][n] for k in runs)
                     for n in counters},
    }
    for k, r in runs.items():
        info[k] = {"seconds": r["seconds"],
                   "tokens": sum(x.completion_tokens for x in r["results"]),
                   "health": (None if r["health"] is None else {
                       h: r["health"][h] for h in (
                           "forced_tokens_total", "masked_steps_total",
                           "fast_forward_splices_total",
                           "dead_ends_total")})}
    log(f"[{tag}] fast-forward on: {on['health']['masked_steps_total']} "
        f"masked steps against {off['health']['masked_steps_total']} off; "
        f"{len(mid)} mid-stream splices (ragged launches {mid}); near-tie "
        f"mismatches: {len(near_ff)} on/off, {len(near_perm)} "
        f"permissive/off; {gpu_line()}")
    return info


# ----------------------------------------------------------- serve_spec

#: (a): Gemma-7B int4 verifies Gemma-2B's drafts, over HTTP, at serve's
#: MAX_NEW_TOKENS (128; random weights never emit EOS, so every request
#: runs its whole budget).
SPEC_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda",
    "MODEL_NAME": "gemma-7b-it", "DTYPE": "bfloat16", "QUANT": "int4",
    "DECODE_BATCH_SIZE": str(N_SLOTS),
    "TOKENIZER_PATH": str(ROOT / PACKAGE / "assets" / "tokenizer-k8s.json"),
    "RATE_LIMIT": "1000/minute", "LLM_TIMEOUT": "300",
    "SPEC_DECODE": "true", "SPEC_DRAFT_MODEL": "gemma-2b-it",
    "SPEC_DRAFT_K": str(SPEC_K),
}
SPEC_FAMILIES = ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                 "spec_acceptance_ratio")
#: (b): Gemma-2B drafting for itself (its own seed), one burst of these
#: prompts, each greedy and at 0.9, per engine
SPEC_B_PROMPTS = ["list all pods", "scale web", "show nodes",
                  "delete the job"]
SPEC_B_TOKENS = 40
SPEC_B_KS = (2, 4)


def phase_serve_spec(torch) -> dict:
    """Phase 13: speculative decoding: (a) Gemma-7B int4 verifying
    Gemma-2B over HTTP, then the same target with spec off; (b) Gemma-2B
    with an identical draft at k = 2 and 4 in the ragged and gather
    regimes against spec off, and a draft:die drill."""
    release_served_apps(torch)
    return asyncio.run(_serve_spec(torch))


async def _serve_spec(torch) -> dict:
    a = await _spec_http(torch)
    release_served_apps(torch)
    b = await _spec_engines(torch)
    release_served_apps(torch)
    return {"http": a, "engines": b,
            "launches": {n: a["launches"][n] + b["launches"][n]
                         for n in _launch_counters()}}


def _spec_gate_mismatches(torch, tag, engine, prompts, want, got) -> list:
    """Each (prompt ids, temperature, seed) pair's transcripts must be
    equal, or apart first at a near tie (``_first_mismatch``); returns
    the near ties. serve_spec's rule, which serve_host holds too."""
    out = []
    for (ids, temp, seed), a, b in zip(prompts, want, got):
        miss = _first_mismatch(torch, engine, ids, a, b, temp, seed)
        if miss is None:
            continue
        out.append(dict(miss, temperature=temp))
        if miss["gap"] > miss["tolerance"]:
            raise AssertionError(f"{tag}: a transcript (temperature "
                                 f"{temp}) leaves its reference's away from "
                                 f"a near tie: {miss}")
    return out


def _spec_books(tag: str, inner) -> dict:
    """The pool's books and the ledger: draft_rejected equal to drafted
    minus accepted, conservation balanced. Returns the spec section."""
    check_pool_books(inner)
    h = inner.spec_health()
    ledger = inner.ledger_snapshot()
    rejected = ledger["classes"]["draft_rejected"]
    if rejected != h["drafted_tokens_total"] - h["accepted_tokens_total"]:
        raise AssertionError(f"{tag}: draft_rejected {rejected} against "
                             f"{h}")
    if not ledger["conservation"]["balanced"]:
        raise AssertionError(f"{tag}: ledger unbalanced: "
                             f"{ledger['conservation']}")
    return h


async def _spec_http(torch) -> dict:
    """(a): the serve burst and its repeats over HTTP with Gemma-7B int4
    verifying Gemma-2B's drafts (k = 4, the pool and ragged regime, 8
    slots; target seed 0, draft seed 1); then the same target weights
    with spec off, the same prompts at once, against them."""
    import dataclasses

    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import (
        BatchedTorchEngine, default_seed)
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = "serve_spec/http"
    port = _free_port()
    _phase_env(SPEC_ENV, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine) or not inner.spec_decode:
        raise AssertionError(f"{tag}: engine construction failed: {inner!r}")
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    if inner._attention_regime != "ragged":
        raise AssertionError(f"{tag}: regime {inner._attention_regime}")
    log(f"[{tag}] {cfg.model_name} ({cfg.quant}) verifying "
        f"{inner._draft_cfg.name} at k={inner.spec_draft_k} up in "
        f"{startup_s:.1f} s: {inner._spec_steps} verify iterations a chunk, "
        f"{inner._chunk_tokens}-token rows, span {inner._S_alloc}")
    url = f"http://{cfg.host}:{port}"
    counters = _launch_counters()
    # The admission width of each ragged prologue the traffic sends
    # Gemma-7B: each must be one that phase 2 checks.
    widths = []
    prologue = inner._prologue

    def spy(adm, *args, **kw):
        widths.append(int(adm[0].shape[1]))
        return prologue(adm, *args, **kw)

    inner._prologue = spy
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counters.values():
                fn.launches = 0
            mark = (inner.verify_steps, inner.draft_forward_steps,
                    inner.forward_steps, inner._chunks_dispatched)
            h0 = inner.spec_health()
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            burst_s = time.monotonic() - t_burst
            h1 = inner.spec_health()
            burst_counts = [now - was for now, was in zip(
                (inner.verify_steps, inner.draft_forward_steps,
                 inner.forward_steps, inner._chunks_dispatched), mark)]
            repeats = [await ask(QUERIES[i]) for i in REPEATS]
            launches = {n: fn.launches for n, fn in counters.items()}
            verify = inner.verify_steps - mark[0]
            async with http.get(f"{url}/health") as r:
                health = (await r.json())["spec"]
            async with http.get(f"{url}/metrics") as r:
                families = _scrape(await r.text(), SPEC_FAMILIES)
    finally:
        await runner.cleanup()           # drains and stops the engine
        del inner._prologue

    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    statuses = [s for s, _ in burst + repeats]
    for query, (status, body) in zip(QUERIES + [QUERIES[i] for i in REPEATS],
                                     burst + repeats):
        res = results[render_prompt(query)][0]
        want = status_for_text(res.text)
        if status != want or res.completion_tokens <= 0:
            raise AssertionError(f"{tag}: {query!r} HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}")
    if not (health and health["enabled"] and health["active"]
            and health["k"] == SPEC_K and health["drafted_tokens_total"] > 0):
        raise AssertionError(f"{tag}: /health spec {health}")
    want_fam = {"spec_drafted_tokens_total": health["drafted_tokens_total"],
                "spec_accepted_tokens_total":
                    health["accepted_tokens_total"]}
    if ({k: families.get(k) for k in want_fam}
            != {k: float(v) for k, v in want_fam.items()}
            or abs(families.get("spec_acceptance_ratio", -1.0)
                   - health["accepted_tokens_total"]
                   / health["drafted_tokens_total"]) > 1e-9):
        raise AssertionError(f"{tag}: /metrics {families} against /health "
                             f"{health}")
    h = _spec_books(tag, inner)
    n_layers = inner.model_cfg.n_layers
    if (verify <= 0 or launches["ragged_attention_pool"] < n_layers * verify
            or launches["qmatmul4"] <= 0):
        raise AssertionError(f"{tag}: launches {launches} for {verify} "
                             f"verify forwards")
    if not widths or not set(widths) <= set(G7_PROLOGUE_WIDTHS):
        raise AssertionError(f"{tag}: ragged prologues at widths {widths}; "
                             f"phase 2 checks {G7_PROLOGUE_WIDTHS}")
    firsts = [results[render_prompt(q)][0] for q in QUERIES]
    n_tok = sum(r.completion_tokens for r in firsts)
    v_b, d_b, f_b, c_b = burst_counts
    burst_acc = h1["accepted_tokens_total"] - h0["accepted_tokens_total"]
    burst_drafted = h1["drafted_tokens_total"] - h0["drafted_tokens_total"]

    # Spec off on the same target weights (the draft freed first), the
    # burst's prompts at once, as the service sent them.
    params, tok = inner.params, inner.tokenizer
    inner._draft_params = inner._draft_cache = inner._cache = None
    del engine, runner, site, inner
    release_served_apps(torch)
    off = BatchedTorchEngine.from_config(dataclasses.replace(
        cfg, spec_decode=False))
    off.params, off.tokenizer = params, tok
    await off.start()
    try:
        for fn in counters.values():
            fn.launches = 0
        f0 = off.forward_steps
        t_off = time.monotonic()
        off_res = await asyncio.gather(*[
            off.generate(render_prompt(q), max_tokens=cfg.max_new_tokens,
                         temperature=cfg.temperature, timeout=cfg.llm_timeout)
            for q in QUERIES])
        off_s = time.monotonic() - t_off
        off_steps = off.forward_steps - f0
        check_pool_books(off)
        near = _spec_gate_mismatches(
            torch, tag, off,
            [(tok.encode(render_prompt(q)), cfg.temperature,
              default_seed(render_prompt(q))) for q in QUERIES],
            [r.token_ids for r in off_res], [r.token_ids for r in firsts])
    finally:
        await off.stop()
    off_tok = sum(r.completion_tokens for r in off_res)
    info = {
        "startup_s": startup_s, "statuses": statuses,
        "burst_s": burst_s, "burst_tokens": n_tok,
        "burst_tok_per_s": n_tok / burst_s,
        "spec_off_s": off_s, "spec_off_tokens": off_tok,
        "spec_off_tok_per_s": off_tok / off_s,
        "spec_off_ms_per_step": off_s * 1e3 / off_steps,
        "burst_verify_iterations": v_b, "burst_chunks": c_b,
        "ms_per_verify_iteration": burst_s * 1e3 / v_b,
        "draft_forwards_per_chunk": d_b / c_b,
        "target_forwards_per_chunk": f_b / c_b,
        "verify_forwards_per_chunk": v_b / c_b,
        "burst_acceptance": (burst_acc / burst_drafted
                             if burst_drafted else None),
        "spec": h, "launches": launches, "verify_forwards": verify,
        "prologue_widths": widths,
        "near_tie_mismatches": near,
        "verify_positions": [r.prompt_tokens + r.completion_tokens // 2
                             for r in firsts],
    }
    log(f"[{tag}] statuses {statuses}; burst {n_tok} tokens in "
        f"{burst_s:.2f} s ({info['burst_tok_per_s']:.1f} tok/s) spec on, "
        f"{off_tok} in {off_s:.2f} s ({info['spec_off_tok_per_s']:.1f} "
        f"tok/s, {info['spec_off_ms_per_step']:.2f} ms a step) spec off; "
        f"acceptance {h['acceptance_ratio']} (burst "
        f"{info['burst_acceptance']}); "
        f"{info['ms_per_verify_iteration']:.2f} ms a verify iteration; a "
        f"chunk {info['draft_forwards_per_chunk']:.2f} draft and "
        f"{info['target_forwards_per_chunk']:.2f} target "
        f"forwards ({info['verify_forwards_per_chunk']:.2f} verify); "
        f"launches ragged {launches['ragged_attention_pool']} over {verify} "
        f"verify forwards, int4 {launches['qmatmul4']}; prologue widths "
        f"{widths}; near ties {len(near)}; no claim; {gpu_line()}")
    return info


async def _spec_engines(torch) -> dict:
    """(b): Gemma-2B (random bf16 from seed 0, 8 slots, the BPE asset)
    with an identical draft (SPEC_DRAFT seed 0 draws the target's own
    weights), k = 2 and 4, one burst of SPEC_B_PROMPTS greedy and at 0.9,
    in the ragged and the gather regime, each against spec off in its
    regime; then draft:die armed mid-burst (after two verify forwards; k
    = 4, ragged), and one more burst after it. ``launches`` sums the
    spec-on engines' and the drill's, ``reference_launches`` the spec-off
    engines'."""
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import load_tokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params
    from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

    tag = "serve_spec/engines"
    cfg = get_config("gemma-2b-it")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         dtype=torch.bfloat16, device="cuda")
    tok = load_tokenizer(cfg, SPEC_ENV["TOKENIZER_PATH"])
    counters = _launch_counters()
    reqs = [(p, t, 3000 + i) for i, p in enumerate(SPEC_B_PROMPTS)
            for t in (0.0, 0.9)]
    prompts = [(tok.encode(p), t, s) for p, t, s in reqs]
    launches = {n: 0 for n in counters}
    reference = {n: 0 for n in counters}

    async def burst(eng):
        res = await asyncio.gather(*[
            eng.generate(p, max_tokens=SPEC_B_TOKENS, temperature=t, seed=s)
            for p, t, s in reqs])
        return [r.token_ids for r in res]

    async def run(regime, k=None, faults=None):
        kw = {} if regime == "ragged" else {"ragged_attention": "off"}
        if k:
            kw.update(spec_decode=True, spec_draft_k=k,
                      spec_draft_model="gemma-2b-it", spec_draft_seed=0)
        eng = BatchedTorchEngine(cfg, tokenizer=tok, params=params,
                                 device="cuda", dtype="bfloat16",
                                 batch_size=N_SLOTS, faults=faults, **kw)
        await eng.start()
        out = {"regime": eng._attention_regime}
        try:
            for fn in counters.values():
                fn.launches = 0
            h0, v0 = eng.spec_health(), eng.verify_steps
            t0 = time.monotonic()
            if faults is None:
                out["ids"] = await burst(eng)
            else:
                task = asyncio.ensure_future(burst(eng))
                while eng.verify_steps - v0 < 2 and not task.done():
                    await asyncio.sleep(0.002)
                if task.done():
                    raise AssertionError(f"{tag}: the burst ended before "
                                         f"the drill was armed")
                faults.set("draft", "die")
                v_at = eng.verify_steps
                out["ids"] = await task
                out["verify_after_drill"] = eng.verify_steps - v_at
                out["again"] = await burst(eng)
                out["spec_steps"] = eng._spec_steps
            out["seconds"] = time.monotonic() - t0
            out["verify"] = eng.verify_steps - v0
            for n, fn in counters.items():
                (launches if k else reference)[n] += fn.launches
            out["ragged"] = counters["ragged_attention_pool"].launches
            if k:
                h = _spec_books(tag, eng)
                out["spec"] = h
                out["drafted"] = (h["drafted_tokens_total"]
                                  - h0["drafted_tokens_total"])
                out["accepted"] = (h["accepted_tokens_total"]
                                   - h0["accepted_tokens_total"])
            else:
                check_pool_books(eng)
                out["engine"] = eng      # its params: the near-tie forward
        finally:
            await eng.stop()
            eng._cache = eng._draft_cache = eng._draft_params = None
        release_served_apps(torch)
        return out

    runs, near = {}, {}
    for regime in ("ragged", "gather"):
        off = runs[(regime, 0)] = await run(regime)
        for k in SPEC_B_KS:
            on = runs[(regime, k)] = await run(regime, k)
            if on["regime"] != off["regime"] or on["verify"] <= 0:
                raise AssertionError(f"{tag}: {regime} k={k}: regime "
                                     f"{on['regime']}, {on['verify']} "
                                     f"verify forwards")
            near[f"{regime}_k{k}"] = _spec_gate_mismatches(
                torch, f"{tag} {regime} k={k}", off["engine"], prompts,
                off["ids"], on["ids"])
            if regime == "ragged" and on["accepted"] <= 0:
                raise AssertionError(f"{tag}: an identical draft accepted "
                                     f"nothing: {on['spec']}")
            log(f"[{tag}] {regime} k={k}: {on['drafted']} drafted, "
                f"{on['accepted']} accepted "
                f"({on['accepted'] / max(1, on['drafted']):.4f}); "
                f"{on['verify']} verify forwards, "
                f"{on['seconds']:.2f} s against {off['seconds']:.2f} s spec "
                f"off; near ties {len(near[f'{regime}_k{k}'])}")
    inj = FaultInjector()
    drill = await run("ragged", SPEC_B_KS[-1], faults=inj)
    h = drill["spec"]
    # A chunk the scheduler was dispatching as the drill was armed may
    # still verify (its iterations); every later one runs plain.
    if (inj.fired("draft") != 1 or h["degraded_total"] != 1 or h["active"]
            or drill["verify_after_drill"] > drill["spec_steps"]):
        raise AssertionError(f"{tag}: draft:die drill: fired "
                             f"{inj.fired('draft')}, {h}, "
                             f"{drill['verify_after_drill']} verify forwards "
                             f"after it")
    ref = runs[("ragged", 0)]
    near["drill"] = _spec_gate_mismatches(torch, f"{tag} drill",
                                          ref["engine"], prompts, ref["ids"],
                                          drill["ids"])
    near["after_drill"] = _spec_gate_mismatches(
        torch, f"{tag} after the drill", ref["engine"], prompts, ref["ids"],
        drill["again"])
    info = {"launches": launches, "reference_launches": reference,
            "near_tie_mismatches": near,
            "drill": {"degraded_total": h["degraded_total"],
                      "verify_after_drill": drill["verify_after_drill"]}}
    for (regime, k), r in runs.items():
        info[f"{regime}_k{k}"] = {
            "seconds": r["seconds"], "verify": r["verify"],
            "drafted": r.get("drafted"), "accepted": r.get("accepted"),
            "ragged_launches": r["ragged"]}
    log(f"[{tag}] draft:die mid-burst: degraded_total 1, "
        f"{drill['verify_after_drill']} verify forwards after it, both "
        f"bursts as spec off (near ties {len(near['drill'])} + "
        f"{len(near['after_drill'])}); {gpu_line()}")
    return info


# ------------------------------------------------------------ serve_host

#: the served Gemma-2B with the two-tier host KV (serve_host): the serve
#: phase's model and slots, sessions of long queries, HOST_KV_BLOCKS
#: host blocks behind a pool sized per regime (_host_pool_blocks), and
#: an injector threaded in at boot (decode:nan at rate 0; each drill
#: arms its own point)
HOST_MAX_NEW = 32
HOST_KV_BLOCKS = 512
HOST_ENV = dict(SERVE_ENV, HOST_KV_BLOCKS=str(HOST_KV_BLOCKS),
                MAX_NEW_TOKENS=str(HOST_MAX_NEW), LLM_TIMEOUT="300",
                FAULT_POINTS="decode:nan:0")
#: (a) the ragged regime at page 16; (b) the legacy ladder, where
#: DECODE_ATTN=paged serves decode through the paged pool kernel (page
#: 64, as DECODE_ATTN=auto raises it for this GQA model) and prefill
#: runs flash over the gathered span
HOST_REGIMES = {
    "ragged": {"KV_POOL_PAGE": "16"},
    "paged": {"RAGGED_ATTENTION": "off", "DECODE_ATTN": "paged",
              "KV_POOL_PAGE": "64"},
}
HOST_SESSIONS = 16
HOST_FAMILIES = ("kv_host_blocks", "kv_blocks_demoted_total",
                 "kv_blocks_onloaded_total", "kv_onload_fail_total",
                 "kv_host_blocks_dropped_total")
HOST_FOLLOW_UP = "and now show only the failing pods"
#: the follow-up's tokens, bounded (the turn-2 prompt bound below)
HOST_FOLLOW_TOKENS = 16
HOST_SESSION_TEXT = (
    "the checkout service in namespace shop-prod returns 502 errors since "
    "the last rollout; the pods restart every few minutes, the readiness "
    "probe fails on port 8080, the deployment has 6 replicas across 3 "
    "nodes, one node reports memory pressure, and the ingress controller "
    "logs show upstream timeouts.")
#: sessions of the TTFT comparison and the pinned copy's size
HOST_TTFT_SESSIONS = 3
PINNED_COPY_BYTES = 256 << 20


def _host_query(i: int) -> str:
    """Session ``i``'s first query: an on-call agent's context, unique
    from its first words (so no two sessions share a page past the
    system prompt's)."""
    return f"session {i} of the on-call agent: {HOST_SESSION_TEXT}"


def _host_turn2(query: str, answer: str) -> str:
    """Turn 2 of a session: turn 1's query, its answer and a follow-up.
    The service renders it into the same template (``User Request:
    ...\\nKubectl Command:``) and collapses its whitespace, so the
    rendered turn 2 shares turn 1's rendered prompt up to the end of the
    query: the pages a returning turn can map. Collapsed here as the
    service collapses it, so the prompt the engine records is the
    rendered one."""
    from ai_agent_kubectl_tpu_torch.server.sanitize import sanitize_query

    return sanitize_query(f"{query} {answer} {HOST_FOLLOW_UP}")


def _host_pool_blocks(p1_max: int, page: int) -> int:
    """The pool of one serve_host regime: every slot at the longest
    turn 2 the phase can send (turn 1's prompt, an answer re-encoded at
    up to twice its tokens, the follow-up, the budget and one chunk of
    coverage) plus two blocks. Eight live slots always fit; sixteen
    sessions' cached chains do not."""
    bound = p1_max + 3 * HOST_MAX_NEW + HOST_FOLLOW_TOKENS + 16
    return N_SLOTS * (-(-bound // page)) + 2


def phase_serve_host(torch) -> dict:
    """Phase 14: the two-tier host KV on Gemma-2B, (a) the ragged regime
    and (b) the paged pool kernel with flash prefill, each over HTTP."""
    release_served_apps(torch)
    return asyncio.run(_serve_host(torch))


async def _serve_host(torch) -> dict:
    out, params = {}, None
    for regime in HOST_REGIMES:
        out[regime], params = await _host_regime(torch, regime, params)
        release_served_apps(torch)
    out["starve"] = await _host_starve(torch, params)
    release_served_apps(torch)
    out["pinned_copy"] = _pinned_copy(torch)
    out["launches"] = {n: out["ragged"]["launches"][n]
                       + out["paged"]["launches"][n]
                       for n in _launch_counters()}
    log(f"[serve_host] pinned copy D2H "
        f"{out['pinned_copy']['d2h_gb_s']:.1f} GB/s, H2D "
        f"{out['pinned_copy']['h2d_gb_s']:.1f} GB/s "
        f"({PINNED_COPY_BYTES >> 20} MiB); {gpu_line()}")
    return out


class _CopySpy:
    """The radix tree's offload and onload functions, wrapped: each
    demote snapshots the block's device bytes (a clone of every K/V
    leaf, on the card) before the payload is read, keyed by the
    payload's CRC32; each onload compares the block it wrote with the
    snapshot of the bytes that went out, bit for bit on the card. Both
    copies are timed between device synchronizations."""

    def __init__(self, torch, inner):
        import zlib

        self.torch, self.inner, self.crc = torch, inner, zlib.crc32
        self.snaps: dict = {}
        self.demote_s, self.onload_s = [], []
        self.checked = self.mismatched = 0
        self.block_bytes = 0
        radix = inner._radix
        self._off, self._on = radix.offload_fn, radix.onload_fn
        radix.offload_fn, radix.onload_fn = self.offload, self.onload

    def offload(self, block):
        torch = self.torch
        snap = [leaf[:, block].clone() for leaf in self.inner._kv_leaves()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = self._off(block)
        self.demote_s.append(time.perf_counter() - t0)
        self.block_bytes = data.size
        self.snaps[self.crc(data.tobytes())] = snap
        return data

    def onload(self, block, data):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._on(block, data)
        torch.cuda.synchronize()
        self.onload_s.append(time.perf_counter() - t0)
        snap = self.snaps.get(self.crc(data.tobytes()))
        if snap is None:
            raise AssertionError(f"onload of block {block}: no demote "
                                 f"snapshot for its payload")
        self.checked += 1
        for leaf, want in zip(self.inner._kv_leaves(), snap):
            if not torch.equal(leaf[:, block].view(torch.uint8),
                               want.view(torch.uint8)):
                self.mismatched += 1
                break

    def summary(self) -> dict:
        def per_block(samples):
            if not samples:
                return None, None
            ms = sorted(samples)[len(samples) // 2] * 1e3
            return ms, self.block_bytes / (ms * 1e-3) / 1e9
        d_ms, d_gbs = per_block(self.demote_s)
        o_ms, o_gbs = per_block(self.onload_s)
        return {"block_bytes": self.block_bytes,
                "demotes_timed": len(self.demote_s),
                "onloads_timed": len(self.onload_s),
                "demote_ms_p50": d_ms, "demote_gb_s": d_gbs,
                "onload_ms_p50": o_ms, "onload_gb_s": o_gbs,
                "onloads_checked": self.checked,
                "onloads_mismatched": self.mismatched}


class _KernelTap:
    """The paged regime's two kernels, wrapped where the model calls them
    (``models/transformer.py``'s names): the latest call at each shape
    keeps a copy of its inputs on the card, taken before the launch and
    with no host sync, so that ``check`` holds each kernel against its
    plain version on the pages, onloaded ones included, and at the shapes
    that the traffic gave it. The wrapped call is the kernel's own launch;
    ``check``'s launches come after the phase reads its counts."""

    NAMES = ("flash_attention_cached", "paged_decode_attention_pool")

    def __init__(self, torch):
        from ai_agent_kubectl_tpu_torch.models import transformer

        self.torch, self.module = torch, transformer
        self.real = {n: getattr(transformer, n) for n in self.NAMES}
        self.inputs: dict = {}
        for name in self.NAMES:
            setattr(transformer, name, self._wrap(name))

    def _wrap(self, name):
        real, Tensor = self.real[name], self.torch.Tensor

        def call(*args, **kw):
            key = (name,) + tuple(tuple(a.shape) for a in args
                                  if isinstance(a, Tensor))
            self.inputs[key] = ([a.clone() if isinstance(a, Tensor) else a
                                 for a in args], dict(kw))
            return real(*args, **kw)
        return call

    def restore(self) -> None:
        for name, fn in self.real.items():
            setattr(self.module, name, fn)

    def check(self, tag: str) -> list:
        """Each captured call's geometry must be one that phase 2 holds
        (G2B_FLASH, PAGED_GEOMETRIES); then kernel against plain on its
        inputs, at check_close's tolerance."""
        from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
            flash_attention_cached_plain)
        from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
            paged_decode_attention_pool_plain)

        plain = {"flash_attention_cached": flash_attention_cached_plain,
                 "paged_decode_attention_pool":
                     paged_decode_attention_pool_plain}
        flash_shapes = {(S, KVLEN) for _, S, KVLEN, _ in G2B_FLASH}
        paged_shapes = {(H, KV, hd, page, span or paged_span(page))
                        for _, (H, KV, hd), page, span in PAGED_GEOMETRIES}
        g2b = (G2B["H"], G2B["KV"], G2B["hd"])
        if {key[0] for key in self.inputs} != set(self.NAMES):
            raise AssertionError(f"{tag}: the tap saw {list(self.inputs)}")
        out = []
        for key, (args, kw) in self.inputs.items():
            name, q, k = key[0], args[0], args[1]
            if name == "flash_attention_cached":
                _, S, H, hd = q.shape
                shape = (S, k.shape[1])
                known = (H, k.shape[2], hd) == g2b and shape in flash_shapes
                at = {"S": S, "KVLEN": k.shape[1],
                      "offset": int(args[3][0, 0])}
            else:
                _, H, hd = q.shape
                page = kw["page_size"]
                span = args[4].shape[1] * page
                known = (H, k.shape[2], hd, page, span) in paged_shapes
                at = {"page": page, "span": span,
                      "positions": args[3].tolist()}
            if not known:
                raise AssertionError(f"{tag}: {name} ran at {key}, a shape "
                                     f"phase 2 does not hold")
            err = check_close(self.torch, f"{tag} {name} {at}",
                              self.real[name](*args, **kw),
                              plain[name](*args, **kw))
            out.append({"kernel": name, **at, "max_abs_err": err})
            log(f"[{tag}] {name} at {at} on the traffic's own inputs: max "
                f"|kernel - plain| = {err:.3e}")
        return out


async def _host_regime(torch, regime: str, params):
    """One regime of phase 14 over HTTP: sixteen two-turn sessions with
    the host tier on, a HOST_KV_BLOCKS=0 engine's cold turn 2 beside
    them, the TTFT of a turn 2 served from host pages against the cold
    re-prefill; in the ragged regime also the onload:corrupt,
    offload:fail and decode:nan drills."""
    import dataclasses

    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import (
        BatchedTorchEngine, default_seed)
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.protocol import RequestQuarantined
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import load_tokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_host/{regime}"
    env = dict(HOST_ENV, **HOST_REGIMES[regime])
    page = int(env["KV_POOL_PAGE"])
    tok = load_tokenizer(get_config(env["MODEL_NAME"]),
                         env["TOKENIZER_PATH"])
    q1s = [_host_query(i) for i in range(HOST_SESSIONS + 8)]
    p1_max = max(len(tok.encode(render_prompt(q))) for q in q1s)
    if len(tok.encode(" " + HOST_FOLLOW_UP)) > HOST_FOLLOW_TOKENS:
        raise AssertionError(f"{tag}: the follow-up outgrew its bound")
    n_blocks = _host_pool_blocks(p1_max, page)
    env["KV_POOL_BLOCKS"] = str(n_blocks)
    port = _free_port()
    _phase_env(env, port)
    cfg = ServiceConfig.from_env()
    inner = build_engine(cfg)
    if not isinstance(inner, BatchedTorchEngine) or inner.faults is None:
        raise AssertionError(f"{tag}: engine construction failed: {inner!r}")
    if params is not None:
        inner.params = params
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    if (inner._attention_regime != regime
            or inner.kv_pool_page != page or inner._host_store is None):
        raise AssertionError(f"{tag}: regime {inner._attention_regime} at "
                             f"page {inner.kv_pool_page}")
    chains = HOST_SESSIONS * (-(-(p1_max + HOST_MAX_NEW) // page))
    log(f"[{tag}] KV_POOL_BLOCKS={n_blocks} of {page} rows "
        f"({inner._pool.n_blocks} blocks; 8 live turn-2 slots fit, "
        f"{HOST_SESSIONS} sessions' chains need about {chains}), "
        f"HOST_KV_BLOCKS={HOST_KV_BLOCKS}, turn-1 prompts up to {p1_max} "
        f"tokens")
    spy = _CopySpy(torch, inner)
    tap = None
    inj = inner.faults
    # The cold reference: the same weights and pool, no host tier.
    cold = BatchedTorchEngine.from_config(dataclasses.replace(
        cfg, host_kv_blocks=0, fault_points=""))
    cold.params, cold.tokenizer = inner.params, inner.tokenizer
    await cold.start()
    url = f"http://{cfg.host}:{port}"
    counters = _launch_counters()
    info = {"pool_blocks": n_blocks, "page": page,
            "host_kv_blocks": HOST_KV_BLOCKS, "p1_max": p1_max}
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query, session):
                async with http.post(
                        f"{url}/kubectl-command", json={"query": query},
                        headers={"X-Session-ID": session}) as r:
                    return r.status

            async def scrape():
                async with http.get(f"{url}/metrics") as r:
                    return _scrape(await r.text(), HOST_FAMILIES)

            def result_of(query):
                hits = [res for p, res in engine.results
                        if p == render_prompt(query)]
                return hits[-1]

            for fn in counters.values():
                fn.launches = 0
            if regime == "paged":
                tap = _KernelTap(torch)
            h0 = inner.kv_pool_health()["host_tier"]
            t0 = time.monotonic()
            st1 = await asyncio.gather(*[
                ask(q, f"s{i}") for i, q in enumerate(q1s[:HOST_SESSIONS])])
            mid = inner.kv_pool_health()["host_tier"]
            q2s = [_host_turn2(q, result_of(q).text)
                   for q in q1s[:HOST_SESSIONS]]
            hits0 = inner._radix.hit_tokens_total
            st2 = await asyncio.gather(*[
                ask(q, f"s{i}") for i, q in enumerate(q2s)])
            traffic_s = time.monotonic() - t0
            if tap is not None:
                tap.restore()
            hits = inner._radix.hit_tokens_total - hits0
            launches = {n: fn.launches for n, fn in counters.items()}
            h1 = inner.kv_pool_health()["host_tier"]
            async with http.get(f"{url}/health") as r:
                health = (await r.json())["kv_pool"]
            families = await scrape()
            check_pool_books(inner)

            # Each kernel of the regime launched in its traffic.
            grown = (("ragged_attention_pool",) if regime == "ragged" else
                     ("paged_decode_attention_pool",
                      "flash_attention_cached"))
            if any(launches[n] <= 0 for n in grown):
                raise AssertionError(f"{tag}: launches {launches}")
            # Gate 1: the traffic demoted chains and onloaded them back.
            demoted = h1["demoted_total"] - h0["demoted_total"]
            onloaded = h1["onloaded_total"] - h0["onloaded_total"]
            if demoted <= 0 or onloaded <= 0:
                raise AssertionError(f"{tag}: {demoted} demoted, {onloaded} "
                                     f"onloaded: {h1}")
            # Gate 2: turn 2's radix hits cover the full pages of turn
            # 1's prompt that turn 2's shares, every session.
            shared = 0
            for q1, q2 in zip(q1s, q2s):
                a, b = (tok.encode(render_prompt(q1)),
                        tok.encode(render_prompt(q2)))
                n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                shared += (n // page) * page
            if hits < shared:
                raise AssertionError(f"{tag}: turn 2 hit {hits} tokens, the "
                                     f"shared full pages hold {shared}")
            # Statuses as the service decides, each turn 2 within bound.
            p2_bound = p1_max + 2 * HOST_MAX_NEW + HOST_FOLLOW_TOKENS
            for q, status in zip(q1s[:HOST_SESSIONS] + q2s, st1 + st2):
                res = result_of(q)
                if (status != status_for_text(res.text)
                        or res.completion_tokens <= 0):
                    raise AssertionError(f"{tag}: HTTP {status} for "
                                         f"{res.text!r}")
                if res.prompt_tokens > p2_bound:
                    raise AssertionError(f"{tag}: a prompt of "
                                         f"{res.prompt_tokens} tokens "
                                         f"outgrew the pool's bound")
            # Gate 3: every onloaded block bit-identical to its demote.
            copies = spy.summary()
            if (copies["onloads_checked"] < onloaded
                    or copies["onloads_mismatched"]):
                raise AssertionError(f"{tag}: onloaded blocks against their "
                                     f"demote snapshots: {copies}")
            # The paged pool kernel and flash against their plain versions
            # at the traffic's own shapes and inputs.
            if tap is not None:
                info["kernel_checks"] = tap.check(tag)
            # Gate 4: each turn 2 as the cold engine serves it alone.
            cold_res = await asyncio.gather(*[
                cold.generate(render_prompt(q), max_tokens=HOST_MAX_NEW,
                              temperature=cfg.temperature,
                              timeout=cfg.llm_timeout) for q in q2s])
            near = _spec_gate_mismatches(
                torch, tag, cold,
                [(tok.encode(render_prompt(q)), cfg.temperature,
                  default_seed(render_prompt(q))) for q in q2s],
                [r.token_ids for r in cold_res],
                [result_of(q).token_ids for q in q2s])
            # Gate 8: /health and /metrics carry the host tier.
            if ("host_tier" not in health
                    or "starved_slots_total" not in health):
                raise AssertionError(f"{tag}: /health kv_pool {health}")
            missing = [f for f in HOST_FAMILIES
                       if not any(k.startswith(f) for k in families)]
            if (missing or families.get("kv_blocks_demoted_total")
                    != h1["demoted_total"]
                    or families.get("kv_blocks_onloaded_total")
                    != h1["onloaded_total"]):
                raise AssertionError(f"{tag}: /metrics host families "
                                     f"{families} (missing {missing}) "
                                     f"against {h1}")
            info.update(
                statuses=st1 + st2, traffic_s=traffic_s,
                demoted=demoted, onloaded=onloaded,
                demoted_before_turn2=mid["demoted_total"] - h0[
                    "demoted_total"],
                turn2_hit_tokens=hits, shared_page_tokens=shared,
                host_tier=h1, near_tie_mismatches=near, launches=launches,
                starved_slots_total=health["starved_slots_total"])
            log(f"[{tag}] {HOST_SESSIONS} sessions x 2 turns in "
                f"{traffic_s:.2f} s: {demoted} blocks demoted "
                f"({info['demoted_before_turn2']} before turn 2), "
                f"{onloaded} onloaded, all {copies['onloads_checked']} "
                f"onloads bit-identical on the card; turn-2 hits {hits} >= "
                f"{shared} shared; near ties {len(near)}; launches "
                f"{launches}")

            # TTFT: a turn 2 from host pages against the cold re-prefill,
            # each alone.
            ttft = {"host": [], "cold": []}
            for i in range(HOST_TTFT_SESSIONS):
                q = q1s[HOST_SESSIONS + i]
                r1 = await inner.generate(render_prompt(q),
                                          max_tokens=HOST_MAX_NEW)
                q2 = render_prompt(_host_turn2(q, r1.text))
                for eng, kind in ((inner, "host"), (cold, "cold")):
                    eng._radix.evict_for(eng._pool.n_blocks)
                    on0 = eng._host_store.onloaded_total if (
                        eng._host_store) else 0
                    r2 = await eng.generate(q2, max_tokens=HOST_MAX_NEW)
                    if kind == "host" and (
                            eng._host_store.onloaded_total == on0):
                        raise AssertionError(f"{tag}: the TTFT turn 2 "
                                             f"onloaded nothing")
                    ttft[kind].append(r2.ttft_ms)
            info["ttft_ms"] = ttft
            info["copies"] = spy.summary()
            c = info["copies"]
            log(f"[{tag}] a {c['block_bytes']}-byte block: demote "
                f"{c['demote_ms_p50']:.3f} ms ({c['demote_gb_s']:.2f} GB/s), "
                f"onload {c['onload_ms_p50']:.3f} ms "
                f"({c['onload_gb_s']:.2f} GB/s), p50 of "
                f"{c['demotes_timed']} and {c['onloads_timed']}; turn-2 "
                f"TTFT from host pages {ttft['host']} ms, cold re-prefill "
                f"{ttft['cold']} ms; no claim; {gpu_line()}")
            if regime == "ragged":
                info["drills"] = await _host_drills(
                    torch, tag, inner, cold, inj, ask, scrape, result_of,
                    RequestQuarantined)
    finally:
        if tap is not None:
            tap.restore()
        await runner.cleanup()
        await cold.stop()
        params = inner.params
        cold._cache = inner._cache = None
    return info, params


async def _host_drills(torch, tag, inner, cold, inj, ask, scrape, result_of,
                       quarantined) -> dict:
    """(a)'s drills, in order: onload:corrupt over HTTP (no failed
    request, one corrupt onload counted, the transcript as cold), then
    offload:fail against the cold engine, then a decode:nan reset with
    the host tier populated (both tiers rebuilt empty, the books
    balanced)."""
    from ai_agent_kubectl_tpu_torch.engine.batcher import default_seed
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    out = {}
    # Gate 5: onload:corrupt.
    q = _host_query(90)
    st1 = await ask(q, "corrupt")
    inner._radix.evict_for(inner._pool.n_blocks)
    if inner._host_store.used <= 0:
        raise AssertionError(f"{tag}: nothing demoted for the corrupt drill")
    before = await scrape()
    q2 = _host_turn2(q, result_of(q).text)
    inj.set("onload", "corrupt")
    st2 = await ask(q2, "corrupt")
    after = await scrape()
    key = "kv_onload_fail_total{cause=corrupt}"
    rise = after.get(key, 0.0) - before.get(key, 0.0)
    if st2 >= 500 or st1 >= 500 or rise != 1:
        raise AssertionError(f"{tag}: onload:corrupt: HTTP {st1}/{st2}, "
                             f"corrupt onloads +{rise}")
    ref = await cold.generate(render_prompt(q2), max_tokens=HOST_MAX_NEW)
    ids = inner.tokenizer.encode(render_prompt(q2))
    near = _spec_gate_mismatches(torch, f"{tag} onload:corrupt", cold,
                                 [(ids, 0.0, default_seed(render_prompt(q2)))],
                                 [ref.token_ids],
                                 [result_of(q2).token_ids])
    out["onload_corrupt"] = {"statuses": [st1, st2], "corrupt_rise": rise,
                             "near_tie_mismatches": near}
    # Gate 6: offload:fail on the eviction, against the cold engine
    # through the same turn 1, eviction and turn 2.
    q = render_prompt(_host_query(91))
    for eng in (inner, cold):
        r1 = await eng.generate(q, max_tokens=HOST_MAX_NEW)
        if eng is inner:
            q2 = render_prompt(_host_turn2(_host_query(91), r1.text))
    store = inner._host_store
    fail0 = store.offload_fail_total
    inj.set("offload", "fail")
    states = []
    for eng in (inner, cold):
        eng._radix.evict_for(eng._pool.n_blocks)
        st = eng.kv_pool_health()
        states.append({k: st[k] for k in ("free", "live", "cached")})
    r2 = [await eng.generate(q2, max_tokens=HOST_MAX_NEW)
          for eng in (inner, cold)]
    if states[0] != states[1] or store.offload_fail_total != fail0 + 1:
        raise AssertionError(f"{tag}: offload:fail: pools {states}, host "
                             f"{store.stats()}")
    near = _spec_gate_mismatches(
        torch, f"{tag} offload:fail", cold,
        [(inner.tokenizer.encode(q2), 0.0, default_seed(q2))],
        [r2[1].token_ids], [r2[0].token_ids])
    out["offload_fail"] = {"pools": states, "near_tie_mismatches": near}
    # Gate 7: decode:nan with the host tier populated.
    await inner.generate(render_prompt(_host_query(92)),
                         max_tokens=HOST_MAX_NEW)
    inner._radix.evict_for(inner._pool.n_blocks)
    store0 = inner._host_store
    s0 = store0.stats()
    if s0["used"] <= 0:
        raise AssertionError(f"{tag}: the reset drill found no host pages")
    inj.target_substr = "poison the host tier"
    inj.set("decode", "nan")
    try:
        await inner.generate(render_prompt("poison the host tier now"),
                             max_tokens=HOST_MAX_NEW)
        raise AssertionError(f"{tag}: decode:nan was not quarantined")
    except quarantined:
        pass
    finally:
        inj.release("decode")
        inj.target_substr = None
    s1 = inner._host_store.stats()
    pool = inner.kv_pool_health()
    if (inner._host_store is store0 or s1["used"] != 0
            or s1["demoted_total"] != s0["demoted_total"]
            or pool["live"] != 0):
        raise AssertionError(f"{tag}: after the reset host {s1} (before "
                             f"{s0}), pool {pool}")
    check_pool_books(inner)
    out["reset"] = {"host_before": s0, "host_after": s1,
                    "resets": inner.supervisor.stats()["resets"]}
    log(f"[{tag}] drills: onload:corrupt HTTP {st1}/{st2}, +1 corrupt, "
        f"near ties {len(out['onload_corrupt']['near_tie_mismatches'])}; "
        f"offload:fail pools {states[0]} as host-off's; decode:nan reset "
        f"left {s0['used']} host pages -> 0, demoted_total carried "
        f"({s1['demoted_total']})")
    return out


async def _host_starve(torch, params) -> dict:
    """Gate 9 (C7): a pool of one full-length sequence's pages shared by
    two slots whose budgets need more: slots are truncated, counted in
    ``starved_slots_total``, and the incident manager fires
    ``pool_exhausted`` from the engine's own view."""
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import load_tokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.obs.incidents import (TRIGGER_POOL,
                                                          IncidentManager)

    tag = "serve_host/starve"
    cfg = get_config("gemma-2b-it")
    eng = BatchedTorchEngine(
        cfg, tokenizer=load_tokenizer(cfg, SERVE_ENV["TOKENIZER_PATH"]),
        params=params, device="cuda", dtype="bfloat16", batch_size=N_SLOTS,
        max_seq_len=256, kv_pool_blocks=16)
    await eng.start()
    try:
        mgr = IncidentManager(ring=4, cooldown_secs=0.0)
        if mgr.evaluate({"kv_pool": eng.kv_pool_health()}, dict):
            raise AssertionError(f"{tag}: an incident before the drill")
        res = await asyncio.gather(*[
            eng.generate(render_prompt(q), max_tokens=160)
            for q in QUERIES[:2]])
        health = eng.kv_pool_health()
        fired = mgr.evaluate({"kv_pool": health}, dict)
        check_pool_books(eng)
    finally:
        await eng.stop()
        eng._cache = None
    starved = health["starved_slots_total"]
    degraded = sum(r.degraded for r in res)
    if (starved < 1 or degraded != starved
            or [b["trigger"] for b in fired] != [TRIGGER_POOL]):
        raise AssertionError(f"{tag}: starved {starved}, degraded "
                             f"{degraded}, incidents {fired}")
    log(f"[{tag}] 16-block pool, 2 slots of 160-token budgets: {starved} "
        f"starved (each result degraded), pool_exhausted fired")
    return {"starved_slots_total": starved,
            "completion_tokens": [r.completion_tokens for r in res]}


def _pinned_copy(torch) -> dict:
    """A large pinned host buffer copied to the card and back, timed with
    CUDA events: the yardstick beside the per-block demote and onload."""
    host = torch.empty(PINNED_COPY_BYTES, dtype=torch.uint8).pin_memory()
    dev = torch.empty(PINNED_COPY_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        out[f"{name}_ms"] = ms
        out[f"{name}_gb_s"] = PINNED_COPY_BYTES / (ms * 1e-3) / 1e9
    del host, dev
    return out


# ------------------------------------------------------------ serve_pipe

#: serve_pipe: serve's cell (Gemma-2B, random bf16 weights from seed 0, 8
#: slots, chunk 16) through the decode chunk pipeline. (a) the ragged
#: regime at CHUNK_PIPE_DEPTH 3 (the default) against 1; (b)
#: DEVICE_TERMINATION=false at depth 2 on the legacy pool ladder (paged
#: decode at page 64, flash prefill), against device termination at
#: depth 1 on that ladder.
PIPE_ENV = dict(SERVE_ENV, RATE_LIMIT="1000/minute")
PIPE_RUNS = {
    "depth3": {"CHUNK_PIPE_DEPTH": "3"},
    "depth1": {"CHUNK_PIPE_DEPTH": "1"},
    "scan": {"CHUNK_PIPE_DEPTH": "2", "DEVICE_TERMINATION": "false",
             "DECODE_ATTN": "paged", "KV_POOL_PAGE": "64"},
    "scan_ref": {"CHUNK_PIPE_DEPTH": "1", "RAGGED_ATTENTION": "off",
                 "DECODE_ATTN": "paged", "KV_POOL_PAGE": "64"},
}
#: (a)'s requests sent one at a time after the burst: seeded, at 0.9,
#: PIPE_SEQ_TOKENS each
PIPE_SEQUENTIAL = [(f"{q} right now", 900 + i)
                   for i, q in enumerate(QUERIES[:4])]
PIPE_TEMPERATURE = 0.9
PIPE_SEQ_TOKENS = 64
#: (a)'s second window: the card made the slower side. Each forward
#: also queues a device-side spin of PIPE_SPIN_FACTOR times the host ms
#: a forward takes (measured in the depth-3 run's traffic), and a burst
#: of 8 fresh queries decodes PIPE_SPIN_TOKENS tokens each.
PIPE_SPIN_FACTOR = 2.0
PIPE_SPIN_TOKENS = 32
#: the host-scan regime's warning (the JAX engine's words)
PIPE_SCAN_WARNING = ("RAGGED_ATTENTION needs DEVICE_TERMINATION (staged "
                     "admissions arm inside the chunk carry); serving the "
                     "legacy ladder")


def phase_serve_pipe(torch) -> dict:
    """The decode chunk pipeline on the card (the docstring's 3b)."""
    return asyncio.run(_serve_pipe(torch))


class _PipeProbe:
    """The scheduler's pipe as the card sees it, on one engine. Each
    dispatch runs under ``torch.cuda.set_sync_debug_mode("error")`` (so
    does each admission): a copy from pageable memory, a ``.item()`` or a
    boolean index there raises and is recorded. Before and after each
    dispatch the events of the chunks already in flight are queried: a
    dispatch that starts, or returns, while an earlier chunk has not
    finished on the card overlapped it. Every host read (``_fetch``) is
    counted and timed, and so is every entry read. The counts go to the
    window named by ``window``."""

    def __init__(self, torch, inner):
        self.torch, self.inner = torch, inner
        self.windows: dict = {}
        self.window = "traffic"
        self.saved = {n: getattr(inner, n) for n in (
            "_dispatch_chunk", "_admit_fresh", "_fetch", "_consume_oldest")}
        inner._dispatch_chunk = self._checked(self._dispatch)
        inner._admit_fresh = self._checked(self.saved["_admit_fresh"])
        inner._fetch = self._fetch
        inner._consume_oldest = self._consume

    def _w(self) -> dict:
        return self.windows.setdefault(self.window, {
            "syncs": [], "host_ms": [], "fetch_ms": [], "dispatches": 0,
            "overlapped_at_start": 0, "overlapped_at_return": 0,
            "max_pipe": 0, "host_reads": 0, "entries_read": 0})

    def _checked(self, fn):
        torch = self.torch

        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            except RuntimeError as e:
                if "synchroniz" in str(e):
                    self._w()["syncs"].append(str(e).splitlines()[0])
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    def _dispatch(self):
        inner, w = self.inner, self._w()
        earlier = [e[1][1] for e in inner._inflight if e[0] == "chunk"]
        start = any(not ev.query() for ev in earlier)
        t0 = time.perf_counter()
        self.saved["_dispatch_chunk"]()
        w["host_ms"].append((time.perf_counter() - t0) * 1e3)
        w["dispatches"] += 1
        w["overlapped_at_start"] += start
        w["overlapped_at_return"] += any(not ev.query() for ev in earlier)
        w["max_pipe"] = max(w["max_pipe"], sum(
            1 for e in inner._inflight if e[0] == "chunk"))

    def _fetch(self, handle):
        t0 = time.perf_counter()
        out = self.saved["_fetch"](handle)
        w = self._w()
        w["fetch_ms"].append((time.perf_counter() - t0) * 1e3)
        w["host_reads"] += 1
        return out

    def _consume(self):
        self._w()["entries_read"] += 1
        return self.saved["_consume_oldest"]()

    def restore(self) -> None:
        for name in self.saved:
            delattr(self.inner, name)

    def summary(self, window: str = "traffic") -> dict:
        w = dict(self.windows.get(window) or self._w())

        def med(xs):
            return sorted(xs)[len(xs) // 2] if xs else None

        host, fetch = w.pop("host_ms"), w.pop("fetch_ms")
        n = w["dispatches"]
        return dict(w, syncs=list(w["syncs"]),
                    overlap_share_at_start=(w["overlapped_at_start"] / n
                                            if n else None),
                    overlap_share_at_return=(w["overlapped_at_return"] / n
                                             if n else None),
                    host_ms_per_dispatch_median=med(host),
                    host_ms_per_dispatch_mean=(sum(host) / n if n else None),
                    fetch_ms_median=med(fetch),
                    fetch_ms_max=max(fetch, default=None))


def _spin_cycles(torch, ms: float) -> int:
    """The ``torch.cuda._sleep`` argument that spins the card for about
    ``ms`` milliseconds (its clock measured with CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return int(20_000_000 / start.elapsed_time(end) * ms)


async def _pipe_engine(torch, name: str, counters: dict, spin: dict):
    """One engine of serve_pipe, built by the factory from the
    environment-style config and served over HTTP: serve's burst of 8 and
    its two repeats, then in (a) the seeded requests one at a time at the
    engine, all under a ``_PipeProbe`` (and in (b)'s host scan a
    ``_KernelTap``); then in (a) the spin window (``spin["ms"]``, set by
    the depth-3 run). Returns the stopped engine (its weights serve the
    near-tie forward) and what was measured."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    port = _free_port()
    _phase_env(dict(PIPE_ENV, **PIPE_RUNS[name]), port)
    cfg = ServiceConfig.from_env()
    tag = f"serve_pipe/{name}"
    with _LogLines() as logs:
        inner = build_engine(cfg)
        if not isinstance(inner, BatchedTorchEngine):
            raise AssertionError(f"{tag}: engine construction failed: "
                                 f"{inner!r}")
        engine = RecordingEngine(inner)
        runner = web.AppRunner(create_app(cfg, engine), access_log=None)
        t0 = time.monotonic()
        await runner.setup()             # starts the engine (warm-up too)
        startup_s = time.monotonic() - t0
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    out = {"regime": inner._attention_regime, "startup_s": startup_s,
           "depth": inner.chunk_pipe_depth,
           "device_termination": inner.device_termination,
           "warned": PIPE_SCAN_WARNING in logs.lines}
    url = f"http://{cfg.host}:{port}"
    tap = _KernelTap(torch) if name == "scan" else None
    probe = _PipeProbe(torch, inner)
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counters.values():
                fn.launches = 0
            s0 = inner.stats()
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            out["burst_s"] = time.monotonic() - t_burst
            repeats = [await ask(QUERIES[i]) for i in REPEATS]
            seq = []
            if name.startswith("depth"):
                for q, seed in PIPE_SEQUENTIAL:
                    seq.append(await inner.generate(
                        render_prompt(q), max_tokens=PIPE_SEQ_TOKENS,
                        temperature=PIPE_TEMPERATURE, seed=seed))
            while inner._inflight:       # the pipe drains behind the end
                await asyncio.sleep(0.005)
            s1 = inner.stats()
            out["forward_steps"] = inner.forward_steps - steps0
            out["launches"] = {n: fn.launches for n, fn in counters.items()}
            async with http.get(f"{url}/metrics") as r:
                out["metrics"] = _scrape(await r.text(), (
                    "wasted_decode_steps_total", "decode_pipe_depth"))
            if name.startswith("depth"):
                if "ms" not in spin:
                    per_forward = (probe.summary()["host_ms_per_dispatch_mean"]
                                   / cfg.chunk_len)
                    spin["ms"] = PIPE_SPIN_FACTOR * per_forward
                    spin["cycles"] = _spin_cycles(torch, spin["ms"])
                forward, cycles = inner._forward, spin["cycles"]

                def spun(*args, **kw):
                    logits = forward(*args, **kw)
                    torch.cuda._sleep(cycles)
                    return logits

                inner._forward, probe.window = spun, "spin"
                t_spin = time.monotonic()
                spin_res = await asyncio.gather(*[
                    inner.generate(render_prompt(f"{q} again"),
                                   max_tokens=PIPE_SPIN_TOKENS,
                                   temperature=0.0) for q in QUERIES])
                out["spin_s"] = time.monotonic() - t_spin
                del inner._forward
                while inner._inflight:
                    await asyncio.sleep(0.005)
    finally:
        probe.restore()
        if tap is not None:
            tap.restore()
        await runner.cleanup()           # drains and stops the engine
    out["probe"] = probe.summary()
    if name.startswith("depth"):
        out["spin_probe"] = probe.summary("spin")
        out["spin_tok_per_s"] = (sum(r.completion_tokens for r in spin_res)
                                 / out["spin_s"])
    out["chunks"] = {k: s1[k] - s0[k] for k in (
        "chunks_dispatched", "chunks_consumed", "chunks_pruned",
        "wasted_decode_steps")}
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    for query, (status, body) in zip(QUERIES + [QUERIES[i] for i in REPEATS],
                                     burst + repeats):
        res = results[render_prompt(query)][0]
        want = status_for_text(res.text)
        if status != want or res.completion_tokens <= 0:
            raise AssertionError(f"{tag}: {query!r} HTTP {status}, the "
                                 f"service gives {want} for {res.text!r}: "
                                 f"{body}")
    firsts = [results[render_prompt(q)][0] for q in QUERIES]
    again = [results[render_prompt(QUERIES[i])][1] for i in REPEATS]
    for i, r in zip(REPEATS, again):
        if r.token_ids != firsts[i].token_ids:
            raise AssertionError(f"{tag}: the repeat of {QUERIES[i]!r} "
                                 f"changed its greedy tokens")
    out["burst_tokens"] = sum(r.completion_tokens for r in firsts)
    out["burst_tok_per_s"] = out["burst_tokens"] / out["burst_s"]
    out["burst_ttft_ms_p50"] = sorted(r.ttft_ms for r in firsts)[4]
    out["ids"] = {"burst": [list(r.token_ids) for r in firsts],
                  "seq": [list(r.token_ids) for r in seq],
                  "spin": ([list(r.token_ids) for r in spin_res]
                           if name.startswith("depth") else [])}
    out["prompt_ids"] = [inner.tokenizer.encode(render_prompt(q))
                         for q in QUERIES]
    out["spin_prompt_ids"] = [
        inner.tokenizer.encode(render_prompt(f"{q} again")) for q in QUERIES]
    check_pool_books(inner)
    if tap is not None:
        out["tap"] = tap.check(tag)
    p = out["probe"]
    log(f"[{tag}] {out['regime']} regime, depth {out['depth']}, "
        f"{'device' if out['device_termination'] else 'host-scan'} "
        f"termination: burst {out['burst_tok_per_s']:.1f} tok/s, TTFT p50 "
        f"{out['burst_ttft_ms_p50']:.0f} ms; "
        f"{p['dispatches']} dispatches ({p['overlapped_at_start']} began, "
        f"{p['overlapped_at_return']} returned with an earlier chunk "
        f"running on the card), pipe up to {p['max_pipe']}, host "
        f"{p['host_ms_per_dispatch_median']:.2f} ms a dispatch (median), "
        f"fetch median {p['fetch_ms_median']:.3f} ms max "
        f"{p['fetch_ms_max']:.3f} ms; {p['host_reads']} host reads for "
        f"{p['entries_read']} entries; chunks {out['chunks']}; "
        f"/metrics {out['metrics']}; {len(p['syncs'])} synchronizing calls")
    if name.startswith("depth"):
        q = out["spin_probe"]
        log(f"[{tag}] with a {spin['ms']:.1f} ms device spin a forward: "
            f"{out['spin_tok_per_s']:.1f} tok/s; {q['dispatches']} "
            f"dispatches ({q['overlapped_at_start']} began, "
            f"{q['overlapped_at_return']} returned with an earlier chunk "
            f"running on the card), host "
            f"{q['host_ms_per_dispatch_median']:.1f} ms a dispatch (median),"
            f" pipe up to {q['max_pipe']}, fetch "
            f"median {q['fetch_ms_median']:.3f} ms max "
            f"{q['fetch_ms_max']:.3f} ms, {len(q['syncs'])} synchronizing "
            f"calls")
    return inner, out


async def _serve_pipe(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
        flash_attention_cached)
    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool)
    from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
        ragged_attention_pool)

    counters = {"ragged_attention_pool": ragged_attention_pool,
                "flash_attention_cached": flash_attention_cached,
                "paged_decode_attention_pool": paged_decode_attention_pool}
    runs, near, spin = {}, {}, {}
    for name in PIPE_RUNS:
        inner, out = await _pipe_engine(torch, name, counters, spin)
        runs[name] = out
        ref = {"depth1": "depth3", "scan_ref": "scan"}.get(name)
        if ref is not None:
            # The near-tie forward runs on this (reference) engine's
            # weights: every engine drew the same seed-0 init.
            a, b = runs[ref]["ids"], out["ids"]
            prompts = [(ids, 0.0, 0) for ids in out["prompt_ids"]]
            near[ref] = _spec_gate_mismatches(
                torch, f"serve_pipe/{ref}", inner, prompts, b["burst"],
                a["burst"])
            if name == "depth1":
                near["spin"] = _spec_gate_mismatches(
                    torch, "serve_pipe/spin", inner,
                    [(ids, 0.0, 0) for ids in out["spin_prompt_ids"]],
                    b["spin"], a["spin"])
            if name == "depth1" and b["seq"] != a["seq"]:
                raise AssertionError(
                    "serve_pipe: the sequential seeded transcripts differ "
                    "between depths 3 and 1")
        inner.params = inner._cache = None
        del inner
        release_served_apps(torch)
    d3, d1, scan, scan_ref = (runs[k] for k in PIPE_RUNS)
    n_layers = get_config(SERVE_ENV["MODEL_NAME"]).n_layers
    failures = []
    for name, r in runs.items():
        for p in (r["probe"], r.get("spin_probe", r["probe"])):
            if p["syncs"]:
                failures.append(f"{name}: synchronizing calls between "
                                f"dispatches: {p['syncs'][:3]}")
            if p["host_reads"] != p["entries_read"]:
                failures.append(f"{name}: {p['host_reads']} host reads "
                                f"for {p['entries_read']} entries read")
    if d3["regime"] != "ragged" or d1["regime"] != "ragged":
        failures.append(f"(a) regimes {d3['regime']}, {d1['regime']}")
    if d3["probe"]["max_pipe"] != 3:
        failures.append(f"(a) the pipe reached {d3['probe']['max_pipe']} "
                        f"chunks, not 3")
    if d3["spin_probe"]["overlapped_at_start"] < 1:
        failures.append("(a) with the card the slower side, no dispatch at "
                        "depth 3 began while an earlier chunk ran on it")
    for key in ("probe", "spin_probe"):
        p = d1[key]
        if (p["overlapped_at_start"] or p["overlapped_at_return"]
                or p["max_pipe"] != 1):
            failures.append(f"(a) depth 1 overlapped: {p}")
    for name in ("depth3", "depth1"):
        r = runs[name]
        if r["launches"]["ragged_attention_pool"] < n_layers * \
                r["forward_steps"] or r["forward_steps"] <= 0:
            failures.append(f"{name}: {r['launches']} ragged launches for "
                            f"{r['forward_steps']} forward steps")
    if not (scan["regime"] == "paged" and scan["warned"]
            and not scan["device_termination"] and scan["depth"] == 2):
        failures.append(f"(b) resolved to {scan['regime']} (warning logged: "
                        f"{scan['warned']})")
    if scan["ids"]["burst"] != scan_ref["ids"]["burst"]:
        failures.append("(b) the host scan's greedy transcripts differ from "
                        "the device-terminated ladder's")
    for name in ("scan", "scan_ref"):
        got = runs[name]["launches"]
        if (got["paged_decode_attention_pool"] <= 0
                or got["flash_attention_cached"] <= 0):
            failures.append(f"{name}: launches {got}")
    wasted = scan["metrics"].get("wasted_decode_steps_total")
    if wasted is None or wasted < 0 or \
            scan["metrics"].get("decode_pipe_depth") != 2:
        failures.append(f"(b) /metrics {scan['metrics']}")
    if failures:
        raise AssertionError("serve_pipe: " + "; ".join(failures))
    info = {
        "spin": spin,
        "runs": {k: {kk: vv for kk, vv in v.items()
                     if kk not in ("ids", "prompt_ids", "spin_prompt_ids")}
                 for k, v in runs.items()},
        "near_tie_mismatches": near,
        "launches": {n: sum(r["launches"][n] for r in runs.values())
                     for n in counters},
    }
    log(f"[serve_pipe] (a) burst {d3['burst_tok_per_s']:.1f} tok/s at depth "
        f"3 against {d1['burst_tok_per_s']:.1f} at depth 1 (no claim); "
        f"{d3['probe']['overlapped_at_start']}/{d3['probe']['dispatches']} "
        f"dispatches began and {d3['probe']['overlapped_at_return']} "
        f"returned over a running chunk at depth 3; with the {spin['ms']:.1f}"
        f" ms spin {d3['spin_probe']['overlapped_at_start']}/"
        f"{d3['spin_probe']['dispatches']} began and "
        f"{d3['spin_probe']['overlapped_at_return']} returned over one, "
        f"{d3['spin_tok_per_s']:.1f} tok/s against "
        f"{d1['spin_tok_per_s']:.1f} at depth 1; near ties "
        f"{len(near['depth3'])} + {len(near['spin'])}; "
        f"(b) wasted_decode_steps_total "
        f"{wasted:.0f} under the host scan against "
        f"{scan_ref['metrics'].get('wasted_decode_steps_total')} with "
        f"device termination; {gpu_line()}")
    return info


# ------------------------------------------------------------ serve_fleet

#: two Gemma-2B replicas of the serve phase's configuration behind the
#: fleet, on one card; the first rollout drill's fault armed at boot
#: (one-shot, replica 0: its next checkpoint load fails validation)
FLEET_ENV = dict(SERVE_ENV, FLEET_SIZE="2", LLM_TIMEOUT="300",
                 ROLLOUT_OBSERVE_SECS="3", ROLLOUT_CANARY_SHARE="0.5",
                 FAULT_POINTS="r0:checkpoint:corrupt",
                 # The promotion gate compares the canary's fast-window
                 # SLO burn (300 s, its history before the rollout
                 # included) with the stable replica's; at a few dozen
                 # samples a replica, one slow request of (a) or (b)
                 # would roll a healthy checkpoint back. The drills here
                 # are the rollout's mechanics; the gate's verdicts are
                 # tested on the CPU (tests/test_torch_rollout.py).
                 SLO_TTFT_MS="60000", SLO_INTERACTIVE_MS="60000",
                 # A promotion drains the stable replica while the canary
                 # serves: an established stream there finishes in place
                 # within DRAIN_TIMEOUT_SECS or is cut (it may not cross
                 # versions). With both replicas decoding, the two
                 # scheduler threads share one interpreter lock and a
                 # decode step takes ~100 ms, not ~30: a 128-token
                 # request needs ~13 s, past the 10 s default.
                 DRAIN_TIMEOUT_SECS="60")
#: (a): sixteen concurrent queries (two replicas of eight slots), then
#: the serve phase's two repeats
FLEET_QUERIES = QUERIES + [f"{q} right now" for q in QUERIES]
#: (b): eight requests seated on replica 0, four greedy and four seeded
#: at 0.9, each held until it has this many tokens before drain(0)
FLEET_MIGRATE = [(QUERIES[i], 0.0 if i % 2 == 0 else 0.9, 500 + i)
                 for i in range(N_SLOTS)]
FLEET_MIGRATE_TOKENS = 128
FLEET_MIGRATE_AT = 32
#: (c): the rollout drills' checkpoints (dev sentinels: v1 is the
#: served weights, v2 a random init from seed 1) and the probe
FLEET_V1 = "dev:gemma-2b-it:seed=0:quant="
FLEET_V2 = "dev:gemma-2b-it:seed=1:quant="
FLEET_PROBE = "show the rollout history of deployment web"
FLEET_PROBE_TOKENS = 64
FLEET_FAMILIES = ("fleet_replicas", "fleet_replica_occupancy",
                  "fleet_replica_inflight", "fleet_replica_breaker_state",
                  "fleet_migrations_total", "fleet_migrated_tokens_total",
                  "fleet_hedges_total", "fleet_drains_total",
                  "fleet_ejects_total", "fleet_rejoins_total")
ROLLOUT_FAMILIES = ("rollout_state", "rollout_replicas",
                    "rollout_rollbacks_total")


def phase_serve_fleet(torch, serve_info: dict) -> dict:
    """Phase 15: the engine fleet and the weight rollout, two Gemma-2B
    replicas on one card over HTTP."""
    release_served_apps(torch)
    out = asyncio.run(_serve_fleet(torch))
    release_served_apps(torch)
    if serve_info.get("burst_tok_per_s"):
        log(f"[serve_fleet] burst tok/s: serve {serve_info['burst_tok_per_s']:.1f}"
            f" (8 requests, one engine, every layer, an earlier phase; no "
            f"claim)")
    return out


class _LaunchWindows:
    """The launch counters read in windows, so that the fleet's launches
    come from the fleet's own traffic alone. ``window(kind, segment)``
    zeroes every counter as it opens and, as it closes, adds what each
    read to ``books[kind]``: ``fleet`` for the fleet's traffic,
    ``reference`` for the runs its transcripts are held against (the
    near-tie forwards run outside every window). A fleet window also
    keeps the replicas' forward steps inside it, and ``gate`` holds each
    fleet window's ragged launches against them: every forward step
    launches the kernel once per layer."""

    def __init__(self, engines):
        self.counters = _launch_counters()
        self.engines = engines
        self.books = {k: dict.fromkeys(self.counters, 0)
                      for k in ("fleet", "reference")}
        self.segments: dict = {}

    @contextlib.contextmanager
    def window(self, kind: str, segment: str | None = None):
        for fn in self.counters.values():
            fn.launches = 0
        steps0 = [e.forward_steps for e in self.engines]
        yield
        read = {n: fn.launches for n, fn in self.counters.items()}
        for n, v in read.items():
            self.books[kind][n] += v
        if kind == "fleet":
            seg = self.segments.setdefault(
                segment, {"ragged": 0, "forward_steps": [0] * len(steps0)})
            seg["ragged"] += read["ragged_attention_pool"]
            seg["forward_steps"] = [
                n + e.forward_steps - s0 for n, e, s0 in
                zip(seg["forward_steps"], self.engines, steps0)]

    def gate(self, tag: str, n_layers: int) -> None:
        for name, seg in self.segments.items():
            steps = sum(seg["forward_steps"])
            if steps <= 0 or seg["ragged"] < n_layers * steps:
                raise AssertionError(f"{tag} ({name}): {seg['ragged']} "
                                     f"ragged launches for "
                                     f"{seg['forward_steps']} forward steps "
                                     f"of {n_layers} layers")


class _RaggedTap:
    """The ragged kernel wrapped where the model calls it (both replicas
    call the one module-level name): the latest call at each shape keeps
    a copy of its inputs on the card, taken before the launch, so that
    ``check`` holds the kernel against its plain version at every shape
    the traffic ran, on the traffic's own inputs. The wrapped call is the
    kernel's own launch; ``check``'s launches come after the phase reads
    its counts."""

    def __init__(self, torch):
        from ai_agent_kubectl_tpu_torch.models import transformer

        self.torch, self.module = torch, transformer
        self.real = transformer.ragged_attention_pool
        self.inputs: dict = {}
        self.calls: dict = {}

        def call(q, k, v, q_lens, positions, tables, **kw):
            key = self.key(q, k, tables, kw["page_size"])
            self.calls[key] = self.calls.get(key, 0) + 1
            self.inputs[key] = ([a.clone() for a in (q, k, v, q_lens,
                                                     positions, tables)],
                                dict(kw))
            return self.real(q, k, v, q_lens, positions, tables, **kw)

        transformer.ragged_attention_pool = call

    @staticmethod
    def key(q, k, tables, page) -> tuple:
        N, W, H, hd = q.shape
        return (N, W, H, k.shape[2], hd, page, tables.shape[1])

    def restore(self) -> None:
        self.module.ragged_attention_pool = self.real

    def check(self, tag: str) -> list:
        """Each shape must be one that phase 2 holds (ragged_cases), then
        kernel against plain on its captured inputs."""
        from ai_agent_kubectl_tpu_torch.ops.ragged_attention import (
            ragged_attention_pool_plain)

        torch = self.torch
        gen = torch.Generator(device="cuda").manual_seed(1234)
        held = {self.key(c["q"], c["k"], c["block_tables"], c["k"].shape[1])
                for _, c in ragged_cases(torch, gen)}
        torch.cuda.empty_cache()
        out = []
        for key, (args, kw) in sorted(self.inputs.items()):
            if key not in held:
                raise AssertionError(f"{tag}: ragged attention ran at {key} "
                                     f"(N, W, H, KV, hd, page, pages), a "
                                     f"shape phase 2 does not hold")
            err = check_close(torch, f"{tag} ragged {key}",
                              self.real(*args, **kw),
                              ragged_attention_pool_plain(*args, **kw))
            out.append({"shape": key, "calls": self.calls[key],
                        "max_abs_err": err})
            log(f"[{tag}] ragged at (N, W)={key[:2]}, {self.calls[key]} "
                f"calls, on the traffic's own last inputs: max |kernel - "
                f"plain| = {err:.3e}")
        return out


async def _serve_fleet(torch) -> dict:
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.fleet import EngineFleet
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.factory import build_engine

    import logging

    tag = "serve_fleet"
    # The fleet's and the rollout's own timelines (drains, swaps,
    # rejoins, gate verdicts), stamped, on stderr for this phase.
    stamped = logging.StreamHandler()
    stamped.setFormatter(logging.Formatter("%(created).3f %(name)s: "
                                           "%(message)s"))
    timelines = [logging.getLogger(f"{PACKAGE}.engine.{m}")
                 for m in ("fleet", "rollout")]
    for lg in timelines:
        lg.addHandler(stamped)
        lg.setLevel(logging.INFO)
    port = _free_port()
    _phase_env(FLEET_ENV, port)
    cfg = ServiceConfig.from_env()
    fleet = build_engine(cfg)
    if not isinstance(fleet, EngineFleet) or len(fleet.replicas) != 2:
        raise AssertionError(f"{tag}: engine construction failed: {fleet!r}")
    engines = [rep.engine for rep in fleet.replicas]
    if not all(isinstance(e, BatchedTorchEngine) for e in engines):
        raise AssertionError(f"{tag}: replicas {engines}")
    engine = RecordingEngine(fleet)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                  # starts both replicas
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    svc = runner.app["service"]
    steady_bytes = torch.cuda.memory_allocated()
    tree_bytes = _tree_bytes(engines[0].params)
    if (len({e.weights_version for e in engines}) != 1
            or engines[0].checkpoint_path != FLEET_V1
            or any(e._attention_regime != "ragged" for e in engines)):
        raise AssertionError(f"{tag}: replicas serve "
                             f"{[(e.weights_version, e.checkpoint_path, e._attention_regime) for e in engines]}")
    log(f"[{tag}] {cfg.model_name} x2 up in {startup_s:.1f} s on one card "
        f"({tree_bytes / 1e9:.3f} GB of weights each, "
        f"{steady_bytes / 1e9:.3f} GB allocated), version "
        f"{engines[0].weights_version}")
    url = f"http://{cfg.host}:{port}"
    win = _LaunchWindows(engines)
    tap = _RaggedTap(torch)
    info = {"startup_s": startup_s, "tree_gb": tree_bytes / 1e9,
            "steady_gb": steady_bytes / 1e9}
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, r.headers.get("X-Model-Version")

            async def get_json(path):
                async with http.get(f"{url}{path}") as r:
                    return r.status, await r.json(), dict(r.headers)

            async def scrape(names):
                async with http.get(f"{url}/metrics") as r:
                    return _scrape(await r.text(), names)

            info["a"] = await _fleet_routing(torch, tag, fleet, engine, ask,
                                             get_json, scrape, win)
            info["b"] = await _fleet_migration(torch, tag, fleet, scrape,
                                               win)
            info["c"] = await _fleet_rollout(torch, tag, cfg, fleet, svc,
                                             ask, get_json, http, url,
                                             scrape, tree_bytes, win)
    finally:
        tap.restore()
        await runner.cleanup()            # drains and stops both replicas
        for lg in timelines:
            lg.removeHandler(stamped)
    win.gate(tag, engines[0].model_cfg.n_layers)
    info.update(launches=win.books["fleet"],
                reference_launches=win.books["reference"],
                segments=win.segments)
    info["kernel_check"] = tap.check(tag)
    log(f"[{tag}] ragged launches by the fleet's traffic "
        f"{win.books['fleet']['ragged_attention_pool']} "
        f"({', '.join(f'{k}: {v}' for k, v in win.segments.items())}); by "
        f"the reference runs {win.books['reference']['ragged_attention_pool']}"
        f"; {gpu_line()}")
    return info


async def _fleet_routing(torch, tag, fleet, engine, ask, get_json,
                         scrape, win) -> dict:
    """(a) Sixteen concurrent queries over HTTP, then two repeats: both
    replicas serve, statuses as the service decides, each transcript
    that of one engine on the same weights (replica 0's own, the sixteen
    at once) or apart first at a near tie, /health's fleet section and
    the fleet_* families as the routing went."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    engines = [rep.engine for rep in fleet.replicas]
    engine.results.clear()
    steps0 = [e.forward_steps for e in engines]
    disp0 = [rep.dispatches for rep in fleet.replicas]
    with win.window("fleet", "a"):
        t_burst = time.monotonic()
        burst = await asyncio.gather(*[ask(q) for q in FLEET_QUERIES])
        burst_s = time.monotonic() - t_burst
        repeats = [await ask(FLEET_QUERIES[i]) for i in REPEATS]
    steps = [e.forward_steps - s for e, s in zip(engines, steps0)]
    routed = [rep.dispatches - d for rep, d in zip(fleet.replicas, disp0)]
    _, health, _ = await get_json("/health")
    families = await scrape(FLEET_FAMILIES)
    results = {}
    for prompt, res in engine.results:
        results.setdefault(prompt, []).append(res)
    asked = FLEET_QUERIES + [FLEET_QUERIES[i] for i in REPEATS]
    for query, (status, _) in zip(asked, burst + repeats):
        res = results[render_prompt(query)][0]
        if status != status_for_text(res.text) or res.completion_tokens <= 0:
            raise AssertionError(f"{tag} (a): {query!r} HTTP {status} for "
                                 f"{res.text!r}")
    if min(steps) <= 0 or sum(routed) != len(asked) or min(routed) <= 0:
        raise AssertionError(f"{tag} (a): forward steps {steps}, routed "
                             f"{routed}")
    fh = health["fleet"]
    if ([r["dispatches"] for r in fh["replicas"]]
            != [rep.dispatches for rep in fleet.replicas]
            or fh["active"] != 2 or fh["migrations"] != 0):
        raise AssertionError(f"{tag} (a): /health fleet {fh}")
    want_fam = {'fleet_replicas{state=active}': 2.0,
                'fleet_replicas{state=draining}': 0.0,
                'fleet_replicas{state=ejected}': 0.0,
                'fleet_migrations_total': 0.0, 'fleet_drains_total': 0.0}
    want_fam.update({f"fleet_replica_breaker_state{{replica={i}}}": 0.0
                     for i in range(2)})
    if any(families.get(k) != v for k, v in want_fam.items()):
        raise AssertionError(f"{tag} (a): /metrics {families}")
    # The reference: replica 0 alone, the sixteen prompts in two waves of
    # its eight slots. (A wave queued behind another would put SLO
    # breaches on this replica's books, and the rollout gate of (c)
    # judges a canary by its whole fast window.)
    firsts = [results[render_prompt(q)][0] for q in FLEET_QUERIES]
    ref = []
    with win.window("reference"):
        t_ref = time.monotonic()
        for w in range(0, len(FLEET_QUERIES), N_SLOTS):
            ref += await asyncio.gather(*[
                engines[0].generate(render_prompt(q),
                                    max_tokens=r.completion_tokens)
                for q, r in zip(FLEET_QUERIES[w:w + N_SLOTS],
                                firsts[w:w + N_SLOTS])])
        ref_s = time.monotonic() - t_ref
    ties = []
    for q, got, want in zip(FLEET_QUERIES, firsts, ref):
        tie = _first_mismatch(torch, engines[0],
                              engines[0].tokenizer.encode(render_prompt(q)),
                              want.token_ids, got.token_ids, 0.0, 0)
        if tie is not None:
            if tie["gap"] > tie["tolerance"]:
                raise AssertionError(f"{tag} (a): {q!r} left one engine's "
                                     f"transcript at {tie}")
            ties.append(tie)
    for i in REPEATS:
        first, again = results[render_prompt(FLEET_QUERIES[i])][:2]
        if not again.prefix_cache_hit:
            raise AssertionError(f"{tag} (a): repeat {i} missed the radix")
    n_tok = sum(r.completion_tokens for r in firsts)
    ref_tok = sum(r.completion_tokens for r in ref)
    log(f"[{tag}] (a) statuses {sorted(set(s for s, _ in burst + repeats))}; "
        f"requests per replica {routed}, forward steps {steps}; {n_tok} "
        f"tokens in {burst_s:.2f} s ({n_tok / burst_s:.1f} tok/s through "
        f"the fleet, 16 at once); replica 0 alone, two waves of 8: "
        f"{ref_tok / ref_s:.1f} tok/s; near ties {len(ties)}")
    return {"routed": routed, "forward_steps": steps, "burst_s": burst_s,
            "burst_tokens": n_tok, "fleet_tok_per_s": n_tok / burst_s,
            "one_engine_tok_per_s": ref_tok / ref_s, "near_ties": ties,
            "families": families}


async def _fleet_migration(torch, tag, fleet, scrape, win) -> dict:
    """(b) Eight requests seated on replica 0 (replica 1 out of rotation
    while they are routed), its scheduler held once each has
    FLEET_MIGRATE_AT tokens, then drain(0): every request finishes on
    replica 1, each transcript its undisturbed run's (replica 1 alone,
    before) or apart first at a near tie; the migration counters equal
    the requests moved and their exported prefixes; the books balance;
    rejoin(0), and a fresh request routes to it."""
    import threading

    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    e0, e1 = (rep.engine for rep in fleet.replicas)
    prompts = [render_prompt(q) for q, _, _ in FLEET_MIGRATE]
    with win.window("reference"):
        want = await asyncio.gather(*[
            e1.generate(p, max_tokens=FLEET_MIGRATE_TOKENS, temperature=t,
                        seed=s)
            for p, (_, t, s) in zip(prompts, FLEET_MIGRATE)])
    steps0 = [e0.forward_steps, e1.forward_steps]
    disp1 = fleet.replicas[1].dispatches
    reached, opened = threading.Event(), threading.Event()
    real = type(e0)._dispatch_chunk.__get__(e0)

    def held():
        live = [s for s in e0._slots if s is not None]
        if (len(live) == len(FLEET_MIGRATE) and not opened.is_set()
                and min(len(s.detok.ids) for s in live)
                >= FLEET_MIGRATE_AT):
            reached.set()
            opened.wait(120)
        real()

    e0._dispatch_chunk = held
    first_after: dict = {}
    t_drain = [None]

    async def one(i, prompt, temp, seed):
        result = None
        async for event, payload in fleet._stream_events(
                prompt, max_tokens=FLEET_MIGRATE_TOKENS, temperature=temp,
                seed=seed):
            if event == "token":
                if t_drain[0] is not None and i not in first_after:
                    first_after[i] = time.monotonic()
            elif event == "done":
                result = payload
        return result

    fleet.eject(1, cause="manual")
    try:
        with win.window("fleet", "b"):
            tasks = [asyncio.create_task(one(i, p, t, s))
                     for i, (p, (_, t, s)) in enumerate(zip(prompts,
                                                            FLEET_MIGRATE))]
            deadline = time.monotonic() + 120
            while not reached.is_set():
                if (time.monotonic() > deadline
                        or any(t.done() for t in tasks)):
                    raise AssertionError(f"{tag} (b): the eight never held"
                                         f" {FLEET_MIGRATE_AT} tokens each "
                                         f"on replica 0")
                await asyncio.sleep(0.005)
            exported = sorted(len(s.detok.ids) for s in e0._slots
                              if s is not None)
            await fleet.rejoin(1)
            # The scheduler is held: let the relays deliver what replica
            # 0 emitted before it, so every token after t_drain is
            # resumed.
            await asyncio.sleep(0.2)
            t_drain[0] = time.monotonic()
            drain = asyncio.create_task(fleet.drain(0))
            while fleet._migrations < len(FLEET_MIGRATE):
                if drain.done():
                    break
                await asyncio.sleep(0.002)
            opened.set()
            got = await asyncio.gather(*tasks)
            await drain
    finally:
        opened.set()
        del e0._dispatch_chunk
    steps = [e0.forward_steps - steps0[0], e1.forward_steps - steps0[1]]
    fh = fleet.fleet_health()
    moved = fh["migrations"]
    if (moved != len(FLEET_MIGRATE) or fh["migrated_tokens"] != sum(exported)
            or fleet.replicas[1].dispatches - disp1 != len(FLEET_MIGRATE)
            or fleet.replicas[0].eject_cause != "drain"):
        raise AssertionError(f"{tag} (b): moved {moved}, carried "
                             f"{fh['migrated_tokens']} of {exported}, "
                             f"health {fh}")
    families = await scrape(FLEET_FAMILIES)
    if (families.get("fleet_migrations_total") != float(moved)
            or families.get("fleet_migrated_tokens_total")
            != float(sum(exported))
            or families.get("fleet_drains_total") != 1.0):
        raise AssertionError(f"{tag} (b): /metrics {families}")
    ties = []
    for p, (_, temp, seed), w, g in zip(prompts, FLEET_MIGRATE, want, got):
        if g is None:
            raise AssertionError(f"{tag} (b): {p[-40:]!r} gave no result")
        tie = _first_mismatch(torch, e1, e1.tokenizer.encode(p),
                              w.token_ids, g.token_ids, temp, seed)
        if tie is not None:
            if tie["gap"] > tie["tolerance"]:
                raise AssertionError(f"{tag} (b): a migrated transcript "
                                     f"left its undisturbed run at {tie}")
            ties.append(tie)
    books = fleet.ledger_snapshot()["conservation"]
    if not books["balanced"]:
        raise AssertionError(f"{tag} (b): ledger {books}")
    check_pool_books(e1)
    with win.window("fleet", "b"):
        await fleet.rejoin(0)
        disp0 = fleet.replicas[0].dispatches
        fresh = await fleet.generate(render_prompt("list the daemonsets"),
                                     max_tokens=8)
    if (fleet.replicas[0].dispatches != disp0 + 1
            or fleet.fleet_health()["active"] != 2):
        raise AssertionError(f"{tag} (b): a fresh request after rejoin(0) "
                             f"went to {fleet.fleet_health()['replicas']}")
    resume_ms = (max(first_after.values()) - t_drain[0]) * 1e3 \
        if len(first_after) == len(FLEET_MIGRATE) else None
    log(f"[{tag}] (b) drain(0) moved {moved} requests with "
        f"{sum(exported)} exported tokens ({exported}) to replica 1; "
        f"{resume_ms:.1f} ms from drain(0) to the last migrated request's "
        f"first resumed token; near ties {len(ties)}; books balanced; "
        f"rejoin(0) served {fresh.completion_tokens} tokens")
    return {"moved": moved, "exported": exported,
            "migrated_tokens": fh["migrated_tokens"],
            "resume_ms": resume_ms, "near_ties": ties,
            "forward_steps": steps, "families": families}


def _preload_blocks(engine) -> list:
    """The KV bytes of the preloaded system prompt's full pages in the
    engine's radix tree: for each page, every K/V leaf's block, cloned."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import SYSTEM_PROMPT

    ids = engine.tokenizer.encode(SYSTEM_PROMPT)
    page = engine.kv_pool_page
    node, out = engine._radix._root, []
    for i in range(len(ids) // page):
        node = node.children[tuple(ids[i * page:(i + 1) * page])]
        out.append([leaf[:, node.block].clone()
                    for leaf in engine._kv_leaves()])
    return out


def _same_blocks(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        for pa, pb in zip(a, b) for x, y in zip(pa, pb))


async def _fleet_rollout(torch, tag, cfg, fleet, svc, ask, get_json, http,
                         url, scrape, tree_bytes, win) -> dict:
    """(c) Three rollouts over HTTP with a trickle of requests throughout:
    onto the seed-1 sentinel with checkpoint:corrupt armed on replica 0
    (rolled back, both replicas and the probe on v1), then clean (both
    on v2, the probe a fresh v2 engine's), then back onto the seed-0
    sentinel (the probe v1's, byte for byte)."""
    import dataclasses

    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.models.convert import checkpoint_version
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    ctl = svc.rollout
    v1, v2 = checkpoint_version(FLEET_V1), checkpoint_version(FLEET_V2)
    if ctl is None or fleet.weights_version != v1:
        raise AssertionError(f"{tag} (c): rollout {ctl}, fleet "
                             f"{fleet.weights_version}")
    swaps: list = []
    for rep in fleet.replicas:
        real = rep.engine.swap_weights

        def timed(path, _real=real, _idx=rep.idx, **kw):
            t = time.perf_counter()
            try:
                return _real(path, **kw)
            finally:
                torch.cuda.synchronize()
                swaps.append({"replica": _idx, "path": path,
                              "s": time.perf_counter() - t})

        rep.engine.swap_weights = timed
    # The trickle: a request every 0.25 s, at most four in flight,
    # paused while a probe runs alone. Each request's span and status are
    # kept, and the replicas' slots sampled every 0.25 s (printed only
    # when a request is dropped, beside the rollouts' timelines).
    statuses, versions, spans = [], set(), []
    paused, stop = asyncio.Event(), asyncio.Event()
    inflight: set = set()
    samples: list = []

    async def one(i):
        t0 = time.time()
        status, ver = await ask(f"{QUERIES[i % len(QUERIES)]} (trickle {i})")
        statuses.append(status)
        versions.add(ver)
        spans.append((i, round(t0, 3), round(time.time(), 3), status, ver))

    async def trickle():
        i = 0
        while not stop.is_set():
            if not paused.is_set() and len(inflight) < 4:
                t = asyncio.create_task(one(i))
                inflight.add(t)
                t.add_done_callback(inflight.discard)
                i += 1
            samples.append((round(time.time(), 3), [
                (rep.state, rep.engine.ready, len(rep.flights),
                 rep.engine._admissions.qsize(),
                 [(len(s.detok.ids), s.chunks_inflight, s.exhausted)
                  for s in rep.engine._slots if s is not None])
                for rep in fleet.replicas]))
            await asyncio.sleep(0.25)

    async def probe():
        paused.set()
        while inflight:
            await asyncio.sleep(0.01)
        try:
            return await fleet.generate(render_prompt(FLEET_PROBE),
                                        max_tokens=FLEET_PROBE_TOKENS)
        finally:
            paused.clear()

    async def rollout(path):
        """One rollout over HTTP: its status, seconds per state, peak
        device memory above the steady state."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        async with http.post(f"{url}/admin/rollout",
                             json={"checkpoint": path}) as r:
            if r.status != 202:
                raise AssertionError(f"{tag} (c): POST /admin/rollout "
                                     f"{r.status} {await r.text()}")
        t, state, secs = time.monotonic(), ctl.state, {}
        deadline = t + 300
        while ctl.active:
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag} (c): rollout stuck in "
                                     f"{ctl.state}")
            await asyncio.sleep(0.02)
            now = time.monotonic()
            if ctl.state != state or not ctl.active:
                secs[state] = secs.get(state, 0.0) + now - t
                t, state = now, ctl.state
        _, status, _ = await get_json("/admin/rollout")
        peak = torch.cuda.max_memory_allocated()
        return status, secs, (peak - base) / 1e9

    with win.window("fleet", "c"):
        task = asyncio.create_task(trickle())
        drills = {}
        try:
            p1 = await probe()
            if not p1.prefix_cache_hit or p1.weights_version != v1:
                raise AssertionError(f"{tag} (c): v1 probe {p1}")
            kv1 = _preload_blocks(fleet.replicas[0].engine)
            _, h0, hdr0 = await get_json("/health")
            # Drill 1: the checkpoint load fails validation on replica 0.
            st, secs, extra = await rollout(FLEET_V2)
            st1 = st
            if (st["state"] != "rolled_back"
                    or st["last_rollback_cause"] != "checkpoint_corrupt"
                    or set(st["replica_versions"].values()) != {v1}):
                raise AssertionError(f"{tag} (c) drill 1: {st}")
            p1b = await probe()
            if list(p1b.token_ids) != list(p1.token_ids):
                raise AssertionError(f"{tag} (c) drill 1: the probe changed")
            drills["corrupt"] = {"state_secs": secs, "extra_gb": extra,
                                 "rollbacks": st["rollbacks_total"]}
            # Drill 2: a clean rollout to v2.
            n_swaps = len(swaps)
            st, secs, extra = await rollout(FLEET_V2)
            if (st["state"] != "complete"
                    or set(st["replica_versions"].values()) != {v2}):
                raise AssertionError(f"{tag} (c) drill 2: {st}")
            p2 = await probe()
            kv2 = [_preload_blocks(rep.engine) for rep in fleet.replicas]
            _, h2, hdr2 = await get_json("/health")
            families = await scrape(ROLLOUT_FAMILIES)
            drills["clean"] = {"state_secs": secs, "extra_gb": extra,
                               "swap_s": [s["s"] for s in swaps[n_swaps:]],
                               "events": [e["type"] for e in st["events"]]}
            # Drill 3: back onto the served weights' sentinel.
            n_swaps = len(swaps)
            st3, secs3, extra3 = await rollout(FLEET_V1)
            if (st3["state"] != "complete"
                    or set(st3["replica_versions"].values()) != {v1}):
                raise AssertionError(f"{tag} (c) drill 3: {st3}")
            p3 = await probe()
            kv3 = [_preload_blocks(rep.engine) for rep in fleet.replicas]
            drills["back"] = {"state_secs": secs3, "extra_gb": extra3,
                              "swap_s": [s["s"] for s in swaps[n_swaps:]]}
        finally:
            stop.set()
            await task
            while inflight:
                await asyncio.sleep(0.01)
            for rep in fleet.replicas:
                del rep.engine.swap_weights
    if hdr0.get("X-Model-Version") != v1 or hdr2.get("X-Model-Version") != v2:
        raise AssertionError(f"{tag} (c): X-Model-Version "
                             f"{hdr0.get('X-Model-Version')} -> "
                             f"{hdr2.get('X-Model-Version')}")
    if (h2["rollout"]["state"] != "complete"
            or h2["fleet"]["versions"] != {v2: 2}
            or families.get("rollout_state") != 8.0
            or families.get("rollout_rollbacks_total{cause=checkpoint_corrupt}")
            != 1.0
            or families.get(f"rollout_replicas{{version={v2}}}") != 2.0
            or families.get(f"rollout_replicas{{version={v1}}}") != 0.0):
        raise AssertionError(f"{tag} (c): /health {h2['rollout']}, "
                             f"/metrics {families}")
    dropped = [s for s in statuses if s not in (200, 422)]
    if dropped or not statuses:
        for name, d in (("drill 1", st1), ("drill 2", st), ("drill 3", st3)):
            log(f"[{tag}] {name} events: "
                f"{[(e['t'], e['type'], e.get('replica')) for e in d['events']]}")
        log(f"[{tag}] trickle (i, start, end, status, version): {spans}")
        for t, reps in samples:
            log(f"[{tag}] {t} {reps}")
        raise AssertionError(f"{tag} (c): the trickle got {statuses}")
    if list(p3.token_ids) != list(p1.token_ids):
        raise AssertionError(f"{tag} (c) drill 3: the probe is not v1's")
    # Random Gemmas echo their prompt's last token whatever the seed, so
    # v1's and v2's probe transcripts may agree: the preloaded system
    # prompt's KV bytes tell the weights apart. After the v2 rollout
    # every replica's must be a fresh v2 engine's (none of v1's left);
    # after the rollback, v1's again, bit for bit.
    if not all(_same_blocks(torch, kv, kv1) for kv in kv3):
        raise AssertionError(f"{tag} (c) drill 3: the preloaded system "
                             f"prompt's KV is not v1's")
    if any(_same_blocks(torch, kv, kv1) for kv in kv2):
        raise AssertionError(f"{tag} (c) drill 2: v1's system-prompt KV "
                             f"survived the swap")
    # The v2 reference: a fresh engine of the same configuration whose
    # own start draws the seed-1 init (no fleet, no swap).
    fresh = BatchedTorchEngine.from_config(dataclasses.replace(
        cfg, fault_points="", fleet_size=1))
    fresh.seed = 1
    with win.window("reference"):
        await fresh.start()
        try:
            if fresh.weights_version != v2:
                raise AssertionError(f"{tag} (c): fresh engine "
                                     f"{fresh.weights_version}")
            want2 = await fresh.generate(render_prompt(FLEET_PROBE),
                                         max_tokens=FLEET_PROBE_TOKENS)
            kv_fresh = _preload_blocks(fresh)
        finally:
            await fresh.stop()
            fresh._cache = None
            del fresh
    if not (p2.prefix_cache_hit and want2.prefix_cache_hit):
        raise AssertionError(f"{tag} (c): the v2 probes missed the "
                             f"preloaded system prompt")
    if list(p2.token_ids) != list(want2.token_ids):
        raise AssertionError(f"{tag} (c) drill 2: the probe after the "
                             f"swap is not a fresh v2 engine's")
    if not all(_same_blocks(torch, kv, kv_fresh) for kv in kv2):
        raise AssertionError(f"{tag} (c) drill 2: the preloaded system "
                             f"prompt's KV is not a fresh v2 engine's")
    for st_ in (st, st3):
        kinds = [e["type"] for e in st_["events"]]
        for k in ("drain", "swap", "warmup", "rejoin", "observe",
                  "promote", "rollout_complete"):
            if k not in kinds:
                raise AssertionError(f"{tag} (c): no {k} in {kinds}")
    extra_max = max(d["extra_gb"] for d in drills.values())
    log(f"[{tag}] (c) drill 1 rolled back (checkpoint_corrupt), drill 2 "
        f"complete on {v2}, drill 3 back on {v1}; the probe v1 -> v1 -> v2 "
        f"(a fresh v2 engine's, radix hit on the preload; v1's and v2's "
        f"transcripts {'equal' if p1.token_ids == p2.token_ids else 'apart'}"
        f") -> v1 byte for byte; the preloaded system prompt's KV v1 -> a "
        f"fresh v2 engine's -> v1 bit for bit on both replicas; trickle "
        f"{len(statuses)} requests, statuses "
        f"{sorted(set(statuses))}, versions {sorted(v for v in versions if v)}")
    log(f"[{tag}] (c) swap seconds per replica "
        f"{[round(s['s'], 3) for s in swaps]}; peak above steady "
        f"{[round(d['extra_gb'], 3) for d in drills.values()]} GB "
        f"(one tree {tree_bytes / 1e9:.3f} GB); TTFT of the probe before "
        f"{p1.ttft_ms:.1f} ms, after the swap {p2.ttft_ms:.1f} ms; seconds "
        f"per state {drills['clean']['state_secs']}")
    return {"drills": drills, "swaps": swaps,
            "extra_gb_max": extra_max, "tree_gb": tree_bytes / 1e9,
            "ttft_ms": {"before": p1.ttft_ms, "after_swap": p2.ttft_ms},
            "trickle": {"requests": len(statuses),
                        "statuses": sorted(set(statuses))},
            "families": families}


# -------------------------------------------------------------------- main

# ------------------------------------------------------------ serve_tp

#: tensor-parallel serving on the card: Llama-3-8B (random bf16 weights
#: from seed 0, all 32 layers) over a model axis of TP shards, each shard
#: on the one card (the engine's devices=[cuda:0] * TP)
TP = 2
TP_MODEL = "llama-3-8b-instruct"
SERVE_TP_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda", "MODEL_NAME": TP_MODEL,
    "DTYPE": "bfloat16", "DECODE_BATCH_SIZE": str(N_SLOTS),
    "TOKENIZER_PATH": SERVE_ENV["TOKENIZER_PATH"],
    "RATE_LIMIT": "1000/minute", "MESH_SHAPE": f"tp={TP}",
    "MAX_NEW_TOKENS": "64",
}
#: (a) the ragged regime, (b) the paged pool decode, (c) the dense KV
#: ladder, each on the same sharded weights
TP_RUNS = {"ragged": {}, "paged": {"RAGGED_ATTENTION": "off"},
           "dense": {"KV_POOL": "false"}}
#: the kernel each run must launch on every shard (its counter, and the
#: regime /health reports)
TP_RUN_KERNELS = {"ragged": ("ragged_attention_pool_sharded", "ragged"),
                  "paged": ("paged_decode_attention_pool_sharded", "paged"),
                  "dense": ("paged_decode_attention", "paged")}
TP_FAMILIES = ("mesh_devices", "sharding_residual_fraction",
               "kv_pool_mesh_fallback", "spec_draft_sharded",
               "spec_draft_kv_fallback")
# One forward step of the sharded model against the unsharded one on the
# same bf16 weights: each row-parallel product rounds its two partial
# sums to bf16 before adding them (2^-9 relative each, 64 such joins a
# forward), so the two differ by bf16 round-off that compounds over the
# 32 layers. Gate: the rms of the difference within LOGIT_RTOL of the
# logits' rms, its max within TP_LOGIT_MAX of it.
TP_LOGIT_MAX = 0.25


def phase_serve_tp(torch) -> dict:
    """Phase 15b: tensor-parallel serving, two shards on one card."""
    release_served_apps(torch)
    out = asyncio.run(_serve_tp(torch))
    release_served_apps(torch)
    return out


class _ShardTap:
    """The kernels of the sharded forward, wrapped where the model calls
    them (``models/transformer.py``'s names): the two sharded pool
    wrappers and the per-shard dense-ladder reads. The latest call at each
    shape keeps a copy of its inputs (every shard's) on the card, taken
    before the launch, so that ``check`` holds each shard's kernel against
    its plain version on the traffic's own inputs. ``check``'s launches
    come after the phase reads its counts."""

    NAMES = ("ragged_attention_pool_sharded",
             "paged_decode_attention_pool_sharded",
             "paged_decode_attention", "flash_attention_cached")

    def __init__(self, torch):
        from ai_agent_kubectl_tpu_torch.models import transformer

        self.torch, self.module = torch, transformer
        self.real = {n: getattr(transformer, n) for n in self.NAMES}
        self.inputs: dict = {}
        for name in self.NAMES:
            setattr(transformer, name, self._wrap(name))

    def _copy(self, a):
        if isinstance(a, self.torch.Tensor):
            return a.clone()
        if isinstance(a, list):
            return [self._copy(x) for x in a]
        return a

    def _shape(self, a):
        if isinstance(a, self.torch.Tensor):
            return tuple(a.shape)
        if isinstance(a, list):
            return tuple(self._shape(x) for x in a)
        return None

    def _wrap(self, name):
        real = self.real[name]

        def call(*args, **kw):
            key = (name,) + tuple(self._shape(a) for a in args)
            self.inputs[key] = ([self._copy(a) for a in args], dict(kw))
            return real(*args, **kw)
        return call

    def restore(self) -> None:
        for name, fn in self.real.items():
            setattr(self.module, name, fn)

    def check(self, tag: str) -> list:
        from ai_agent_kubectl_tpu_torch.ops.flash_attention import (
            flash_attention_cached_plain)
        from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
            paged_decode_attention_plain)

        plain = {"paged_decode_attention": paged_decode_attention_plain,
                 "flash_attention_cached": flash_attention_cached_plain}
        out = []
        for key, (args, kw) in self.inputs.items():
            name = key[0]
            if name.endswith("_sharded"):
                got = self.real[name](*args, **kw)
                want = self.real[name](*args, **kw, plain=True)
                errs = [check_close(self.torch, f"{tag} {name} shard {i}",
                                    g, w)
                        for i, (g, w) in enumerate(zip(got, want))]
                heads = [tuple(q.shape) for q in args[0]]
            else:
                errs = [check_close(self.torch, f"{tag} {name}",
                                    self.real[name](*args, **kw),
                                    plain[name](*args, **kw))]
                heads = [tuple(args[0].shape)]
            out.append({"kernel": name, "q": heads,
                        "max_abs_err": max(errs)})
            log(f"[{tag}] {name} on the traffic's own inputs, q {heads}: "
                f"max |kernel - plain| = {max(errs):.3e}")
        return out


def _tp_step_logits(torch, params, cfg, ids, mesh=None):
    """One forward step over a fresh pool: the prompt ``ids`` through the
    ragged path, the logits at its last position."""
    from ai_agent_kubectl_tpu_torch.models.transformer import KVCache, forward

    n = len(ids)
    pages = -(-n // PAGE)
    cache = KVCache.pool(cfg, pages, PAGE, dtype=torch.bfloat16,
                         device="cuda", mesh=mesh)
    tables = torch.arange(pages, dtype=torch.int32, device="cuda")[None]
    tok = torch.tensor([ids], dtype=torch.int32, device="cuda")
    pos = torch.arange(n, dtype=torch.int32, device="cuda")[None]
    with torch.no_grad():
        logits, _ = forward(params, cfg, tok, pos, cache,
                            block_tables=tables, attn_impl="ragged",
                            logits_at=torch.tensor([n - 1], device="cuda"),
                            mesh=mesh)
    return logits[0, 0]


async def _tp_run(torch, name: str, params, tap) -> tuple:
    """One engine of serve_tp from the environment-style config with the
    mesh's devices named (``from_config(cfg, devices=...)``), served
    over HTTP: the eight queries at once, counted in a window of their
    own. Returns what was measured and the stopped engine (its sharded
    weights serve the next run)."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    tag = f"serve_tp/{name}"
    port = _free_port()
    _phase_env({**SERVE_TP_ENV, **TP_RUNS[name]}, port)
    cfg = ServiceConfig.from_env()
    inner = BatchedTorchEngine.from_config(
        cfg, devices=[torch.device("cuda", 0)] * TP)
    inner.params = params
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    out = {"startup_s": time.monotonic() - t0,
           "regime": inner._attention_regime}
    if inner.mesh is None or inner.mesh.tp != TP:
        raise AssertionError(f"{tag}: no model axis of {TP} shards")
    log(f"[{tag}] {cfg.model_name} up in {out['startup_s']:.1f} s, "
        f"{inner.mesh.tp} shards on {inner.mesh.devices}, regime "
        f"{inner._attention_regime} (decode {inner._decode_impl})")
    counters = _launch_counters()
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counters.values():
                fn.launches = 0
            steps0 = inner.forward_steps
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            out["burst_s"] = time.monotonic() - t_burst
            while inner._inflight:       # the pipe drains behind the end
                await asyncio.sleep(0.005)
            torch.cuda.synchronize()
            out["launches"] = {n: fn.launches for n, fn in counters.items()}
            out["forward_steps"] = inner.forward_steps - steps0
            async with http.get(f"{url}/health") as r:
                out["sharding"] = (await r.json()).get("sharding")
            async with http.get(f"{url}/metrics") as r:
                out["metrics"] = _scrape(await r.text(), TP_FAMILIES)
        statuses = [s for s, _ in burst]
        want = [status_for_text(res.text)
                for _, res in engine.results[:len(QUERIES)]]
        if sorted(statuses) != sorted(want) or len(engine.results) != \
                len(QUERIES):
            raise AssertionError(f"{tag}: statuses {statuses}, the engine's "
                                 f"results {want}")
        out["prompts"] = [p for p, _ in engine.results]
        out["texts"] = [r.text for _, r in engine.results]
        tokens = sum(r.completion_tokens for _, r in engine.results)
        out["burst_tok_per_s"] = tokens / out["burst_s"]
        if inner.kv_pool:
            check_pool_books(inner)
        leaf = inner._cache.k
        local = inner.model_cfg.n_kv_heads // TP
        for i, shard in enumerate(leaf.shards):
            if not (shard.is_contiguous() and shard.shape[3] == local
                    and shard.device == inner.mesh.devices[i]):
                raise AssertionError(f"{tag}: shard {i}'s K is "
                                     f"{tuple(shard.shape)} on "
                                     f"{shard.device}")
        out["shard_kv_shape"] = list(leaf.shards[0].shape)
    finally:
        await runner.cleanup()           # stops the engine
    return out, inner


async def _serve_tp(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params

    cfg = get_config(TP_MODEL)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    runs, params, mesh = {}, full, None
    tap = _ShardTap(torch)
    try:
        for name in TP_RUNS:
            runs[name], inner = await _tp_run(torch, name, params, tap)
            params, mesh = inner.params, inner.mesh
            inner._cache = None
            del inner
            release_served_apps(torch)
    finally:
        tap.restore()
    # The positions of (a)'s last decode step (the timing phase's).
    for key, (args, _) in tap.inputs.items():
        if key[0] == "ragged_attention_pool_sharded" and \
                args[0][0].shape[1] == 1:
            runs["ragged"]["decode_positions"] = args[4][0].tolist()
    checks = tap.check("serve_tp")
    tap.inputs.clear()
    torch.cuda.synchronize()
    # The unsharded reference engine on the same weights: (a)'s prompts,
    # greedy, its launches counted apart.
    counters = _launch_counters()
    _phase_env({k: v for k, v in SERVE_TP_ENV.items() if k != "MESH_SHAPE"},
               _free_port())
    from ai_agent_kubectl_tpu_torch.config import ServiceConfig

    ref = BatchedTorchEngine.from_config(ServiceConfig.from_env())
    ref.params = full
    await ref.start()
    try:
        for fn in counters.values():
            fn.launches = 0
        t_ref = time.monotonic()
        got = await asyncio.gather(*[
            ref.generate(p, max_tokens=int(SERVE_TP_ENV["MAX_NEW_TOKENS"]),
                         temperature=0.0) for p in runs["ragged"]["prompts"]])
        ref_tok_per_s = (sum(r.completion_tokens for r in got)
                         / (time.monotonic() - t_ref))
        while ref._inflight:
            await asyncio.sleep(0.005)
        ref_launches = {n: fn.launches for n, fn in counters.items()}
        ids = ref.tokenizer.encode(runs["ragged"]["prompts"][0])
    finally:
        await ref.stop()
    same = sum(a == b.text for a, b in zip(runs["ragged"]["texts"], got))
    # One forward step, sharded against unsharded on the same weights.
    sharded_logits = _tp_step_logits(torch, params, cfg, ids, mesh)
    whole_logits = _tp_step_logits(torch, full, cfg, ids)
    rms = float(whole_logits.float().pow(2).mean().sqrt())
    diff = (sharded_logits - whole_logits).float()
    step = {"tokens": len(ids), "rms": rms,
            "max_abs_err": float(diff.abs().max()),
            "rms_err": float(diff.pow(2).mean().sqrt()),
            "argmax_equal": bool(int(sharded_logits.argmax())
                                 == int(whole_logits.argmax()))}
    peak = torch.cuda.max_memory_allocated() - base
    del params, full, ref
    n_layers = cfg.n_layers
    failures = []
    if not torch.isfinite(sharded_logits).all() \
            or step["rms_err"] > LOGIT_RTOL * rms \
            or step["max_abs_err"] > TP_LOGIT_MAX * rms:
        failures.append(f"one step's logits: {step}")
    for name, r in runs.items():
        kernel, regime = TP_RUN_KERNELS[name]
        n = r["launches"][kernel]
        if r["forward_steps"] <= 0 or n <= 0 or n % (TP * n_layers):
            failures.append(f"{name}: {n} {kernel} launches for "
                            f"{r['forward_steps']} forward steps")
        if r["regime"] != regime:
            failures.append(f"{name}: regime {r['regime']}")
        sh = r["sharding"] or {}
        if (sh.get("devices") != TP
                or sh.get("pool_sharded") is not (name != "dense")
                or sh.get("attention_regime") != regime
                or sh.get("residual_tp_fraction") != 1.0):
            failures.append(f"{name}: /health sharding {sh}")
        if (r["metrics"].get("mesh_devices") != TP
                or r["metrics"].get("sharding_residual_fraction") != 1.0):
            failures.append(f"{name}: /metrics {r['metrics']}")
    a = runs["ragged"]
    if a["launches"]["ragged_attention_pool_sharded"] != \
            TP * n_layers * a["forward_steps"]:
        failures.append(f"ragged: {a['launches']} for {a['forward_steps']} "
                        f"forward steps of {n_layers} layers on {TP} shards")
    if runs["dense"]["launches"]["flash_attention_cached"] <= 0:
        failures.append(f"dense: no flash prefill {runs['dense']['launches']}")
    seen = {c["kernel"] for c in checks}
    if seen != set(_ShardTap.NAMES):
        failures.append(f"the tap saw {sorted(seen)}")
    if failures:
        raise AssertionError("serve_tp: " + "; ".join(failures))
    info = {"runs": {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("prompts", "texts")}
                     for k, v in runs.items()},
            "step_logits": step, "kernel_checks": checks,
            "greedy_same_as_unsharded": same,
            "reference_launches": ref_launches,
            "reference_tok_per_s": ref_tok_per_s,
            "peak_gb": peak / 1e9,
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in counters}}
    log(f"[serve_tp] one step's logits against the unsharded forward: rms "
        f"err {step['rms_err']:.4f}, max {step['max_abs_err']:.4f} (logit "
        f"rms {rms:.3f}; argmax equal {step['argmax_equal']}); greedy "
        f"transcripts equal to the unsharded engine's: {same} of "
        f"{len(got)} (not gated: bf16 near ties); bursts "
        + ", ".join(f"{k} {v['burst_tok_per_s']:.1f} tok/s"
                    for k, v in runs.items())
        + f", the unsharded engine's (a) {ref_tok_per_s:.1f} tok/s at the "
        f"engine, not over HTTP (two shards on one card: no claim); peak {peak / 1e9:.1f} GB "
        f"above the phase's start; {gpu_line()}")
    return info


# ------------------------------------------------------- serve_spec_tp

#: speculative decoding on a tp=2 mesh of the one card: serve_spec (a)'s
#: pair (Gemma-7B verifying Gemma-2B drafts, k = 4) at PHASE_LAYERS' cut,
#: the target's QUANT=int4 resolving to int8 on the mesh as in JAX
SPEC_TP_ENV = dict(SPEC_ENV, MESH_SHAPE=f"tp={TP}", MAX_NEW_TOKENS="32")
#: the request served after the burst, with draft:die armed
SPEC_TP_DIE_QUERY = "show the events of the failing pods"
SPEC_TP_FAMILIES = TP_FAMILIES + SPEC_FAMILIES


def phase_serve_spec_tp(torch) -> dict:
    """Phase 15c: speculative decoding on a tp=2 mesh, two shards on one
    card."""
    release_served_apps(torch)
    out = asyncio.run(_serve_spec_tp(torch))
    release_served_apps(torch)
    return out


async def _serve_spec_tp(torch) -> dict:
    """Gemma-7B (random int8 weights from seed 0) verifying Gemma-2B's
    drafts (seed 1) at k = 4 on ``MESH_SHAPE=tp=2`` over HTTP: the serve
    burst at once, then one request with draft:die armed; against the
    same target weights unsharded with spec off."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import (
        BatchedTorchEngine, default_seed)
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.quant import random_params_int8
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text
    from ai_agent_kubectl_tpu_torch.testing.faults import FaultInjector

    tag = "serve_spec_tp"
    mcfg = get_config(SPEC_TP_ENV["MODEL_NAME"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = random_params_int8(torch.Generator(device="cuda").manual_seed(0),
                              mcfg, dtype=torch.bfloat16,
                              quantize_embed=True, device="cuda")
    port = _free_port()
    _phase_env(SPEC_TP_ENV, port)
    cfg = ServiceConfig.from_env()
    inj = FaultInjector()
    inner = BatchedTorchEngine.from_config(
        cfg, faults=inj, devices=[torch.device("cuda", 0)] * TP)
    inner.params = full
    engine = RecordingEngine(inner)
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    await runner.setup()                 # starts the engine (warm-up too)
    site = web.TCPSite(runner, cfg.host, cfg.port)
    await site.start()
    startup_s = time.monotonic() - t0
    if (inner.mesh is None or inner.mesh.tp != TP or inner.quant != "int8"
            or inner._attention_regime != "ragged"):
        raise AssertionError(f"{tag}: mesh {inner.mesh}, quant "
                             f"{inner.quant}, regime "
                             f"{inner._attention_regime}")
    log(f"[{tag}] {cfg.model_name} ({inner.quant} on the mesh; QUANT="
        f"{cfg.quant} asked) verifying {inner._draft_cfg.name} at k="
        f"{inner.spec_draft_k} on {TP} shards of one card, up in "
        f"{startup_s:.1f} s")
    counters = _launch_counters()
    tap = _ShardTap(torch)
    url = f"http://{cfg.host}:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counters.values():
                fn.launches = 0
            v0, h0 = inner.verify_steps, inner.spec_health()
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in QUERIES])
            burst_s = time.monotonic() - t_burst
            while inner._inflight:       # the pipe drains behind the end
                await asyncio.sleep(0.005)
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counters.items()}
            verify = inner.verify_steps - v0
            h1 = inner.spec_health()
            async with http.get(f"{url}/health") as r:
                health = await r.json()
            async with http.get(f"{url}/metrics") as r:
                families = _scrape(await r.text(), SPEC_TP_FAMILIES)
            inj.set("draft", "die")
            die = await ask(SPEC_TP_DIE_QUERY)
            while inner._inflight:
                await asyncio.sleep(0.005)
            h2 = inner.spec_health()
    finally:
        tap.restore()
        await runner.cleanup()           # drains and stops the engine
    by_prompt = dict(engine.results)
    failures = []
    if len(by_prompt) != len(QUERIES) + 1:
        failures.append(f"{len(by_prompt)} results for {len(QUERIES) + 1} "
                        f"requests")
    prompts = [render_prompt(q) for q in QUERIES]
    results = [(p, by_prompt[p]) for p in prompts]
    for (status, _), q in zip(burst + [die], QUERIES + [SPEC_TP_DIE_QUERY]):
        res = by_prompt[render_prompt(q)]
        if status != status_for_text(res.text) or res.completion_tokens <= 0:
            failures.append(f"HTTP {status} for {res.text!r}")
    for view in (health.get("spec") or {}, health.get("sharding") or {}):
        if not (view.get("draft_sharded") is True
                and view.get("draft_kv_fallback") is True):
            failures.append(f"/health {view}")
    want_fam = {"spec_draft_sharded": 1.0, "spec_draft_kv_fallback": 1.0,
                "mesh_devices": float(TP)}
    if {k: families.get(k) for k in want_fam} != want_fam:
        failures.append(f"/metrics {families}")
    drafted = h1["drafted_tokens_total"] - h0["drafted_tokens_total"]
    accepted = h1["accepted_tokens_total"] - h0["accepted_tokens_total"]
    if drafted <= 0 or verify <= 0:
        failures.append(f"drafted {drafted} over {verify} verify forwards")
    if (inj.fired("draft") != 1 or h2["degraded_total"] != 1
            or h2["active"]):
        failures.append(f"draft:die: fired {inj.fired('draft')}, {h2}")
    n_layers = mcfg.n_layers
    n = launches["ragged_attention_pool_sharded"]
    if n <= 0 or n % (TP * n_layers):
        failures.append(f"{n} sharded ragged launches")
    spec_h = _spec_books(tag, inner)
    checks = tap.check(tag)
    tap.inputs.clear()
    windows = sorted({c["q"][0][1] for c in checks
                      if c["kernel"] == "ragged_attention_pool_sharded"})
    if SPEC_K + 1 not in windows:
        failures.append(f"no verify window among the tapped widths "
                        f"{windows}")
    # One forward step, sharded against unsharded on the same weights.
    ids = inner.tokenizer.encode(results[0][0])
    sharded_logits = _tp_step_logits(torch, inner.params, mcfg, ids,
                                     inner.mesh)
    whole_logits = _tp_step_logits(torch, full, mcfg, ids)
    rms = float(whole_logits.float().pow(2).mean().sqrt())
    diff = (sharded_logits - whole_logits).float()
    step = {"tokens": len(ids), "rms": rms,
            "max_abs_err": float(diff.abs().max()),
            "rms_err": float(diff.pow(2).mean().sqrt())}
    if (not torch.isfinite(sharded_logits).all()
            or step["rms_err"] > LOGIT_RTOL * rms
            or step["max_abs_err"] > TP_LOGIT_MAX * rms):
        failures.append(f"one step's logits: {step}")
    tok = inner.tokenizer
    inner.params = inner._draft_params = None
    inner._cache = inner._draft_cache = None
    del engine, runner, site, inner
    release_served_apps(torch)
    # The reference: the same target weights unsharded, spec off, the
    # burst's prompts one batch at once, as the service sent them.
    _phase_env({**{k: v for k, v in SPEC_TP_ENV.items()
                   if k not in ("MESH_SHAPE", "SPEC_DECODE")},
                "QUANT": "int8"}, _free_port())
    ref = BatchedTorchEngine.from_config(ServiceConfig.from_env())
    ref.params, ref.tokenizer = full, tok
    await ref.start()
    try:
        t_ref = time.monotonic()
        want = await asyncio.gather(*[
            ref.generate(p, max_tokens=cfg.max_new_tokens,
                         temperature=cfg.temperature)
            for p in prompts])
        ref_s = time.monotonic() - t_ref
        near = _spec_gate_mismatches(
            torch, tag, ref,
            [(tok.encode(p), cfg.temperature, default_seed(p))
             for p in prompts],
            [r.token_ids for r in want], [r.token_ids for _, r in results])
    finally:
        await ref.stop()
        ref._cache = None
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    n_tok = sum(r.completion_tokens for _, r in results)
    ref_tok = sum(r.completion_tokens for r in want)
    peak = torch.cuda.max_memory_allocated() - base
    del full, ref
    info = {"startup_s": startup_s, "statuses": [s for s, _ in burst],
            "die_status": die[0], "burst_s": burst_s,
            "burst_tok_per_s": n_tok / burst_s,
            "reference_tok_per_s": ref_tok / ref_s,
            "drafted": drafted, "accepted": accepted,
            "acceptance": accepted / drafted, "verify_forwards": verify,
            "spec": spec_h, "launches": launches, "kernel_checks": checks,
            "verify_windows": windows, "step_logits": step,
            "near_tie_mismatches": near, "peak_gb": peak / 1e9,
            "verify_positions": [r.prompt_tokens + r.completion_tokens // 2
                                 for _, r in results]}
    log(f"[{tag}] statuses {info['statuses']} + draft:die {die[0]}; burst "
        f"{n_tok} tokens in {burst_s:.2f} s ({info['burst_tok_per_s']:.1f} "
        f"tok/s) against the unsharded spec-off engine's "
        f"{info['reference_tok_per_s']:.1f} at the engine (two shards on "
        f"one card measure no interconnect: no claim); acceptance "
        f"{accepted}/{drafted} = {info['acceptance']:.4f} over {verify} "
        f"verify forwards; sharded ragged launches "
        f"{launches['ragged_attention_pool_sharded']} (windows {windows}); "
        f"one step's logits: rms err {step['rms_err']:.4f}, max "
        f"{step['max_abs_err']:.4f} (logit rms {rms:.3f}); near ties "
        f"{len(near)}; peak {peak / 1e9:.1f} GB; {gpu_line()}")
    return info


# -------------------------------------------------------- serve_moe_ep

#: Mixtral on expert and data meshes of the one card (serve_moe's cell,
#: MOE_LAYERS of its 32 layers): each run against the unsharded dense
#: engine on the same weights. (a) MOE_IMPL=ep on one device (the
#: one-device expert mesh, int4 attention); (b) tp=2, dense MoE under tp;
#: (c) ep=2; (d) dp=2,ep=2,tp=2 on eight shards, where the pool falls back
#: to the dense ladder. QUANT=int4 serves int8 on (b)-(d), as in JAX.
#: The system prompt's radix preload is off (HBM_PREFIX_CACHE=false): its
#: window would run at prefill capacity and may drop tokens, and every
#: request would inherit that KV; so each request prefills its own prompt.
MOE_EP_ENV = dict(SERVE_MOE_ENV, MAX_NEW_TOKENS="8",
                  HBM_PREFIX_CACHE="false")
MOE_EP_RUNS = {"ep1": {"MOE_IMPL": "ep"}, "tp2": {"MESH_SHAPE": "tp=2"},
               "ep2": {"MESH_SHAPE": "ep=2"},
               "dp2_ep2_tp2": {"MESH_SHAPE": "dp=2,ep=2,tp=2"}}
#: (run, shards, whether the dispatch serves the MoE, the kernel each
#: forward launches once per shard and layer)
MOE_EP_KERNELS = {"ep1": (1, True, "ragged_attention_pool"),
                  "tp2": (2, False, "ragged_attention_pool_sharded"),
                  "ep2": (2, True, "ragged_attention_pool_sharded"),
                  "dp2_ep2_tp2": (8, True, "paged_decode_attention")}
#: the requests each engine serves, one at a time, greedy (two, of 8 new
#: tokens: the phase's six engines must keep the script inside its time
#: budget on a slow host)
MOE_EP_QUERIES = QUERIES[:2]


class _DropTap:
    """The forward's expert-parallel dispatch, wrapped where the model
    calls it: every call's routing is taken again from the router's picks
    per expert shard (``parallel/moe.py::ep_routes``, the capacity the
    call gets) and the live tokens' dropped picks are counted on the
    card; the first prefill call's input, mask, output and dropped tokens
    are kept for the dense check. The package has no drop counter (nor
    has JAX)."""

    def __init__(self, torch):
        from ai_agent_kubectl_tpu_torch.models import transformer

        self.torch, self.module = torch, transformer
        self.real = transformer.expert_parallel_moe
        self.calls = 0
        self.dropped = torch.zeros((), dtype=torch.int64, device="cuda")
        self.captured = None
        transformer.expert_parallel_moe = self._call

    def _call(self, cfg, lps, xs, mesh, *, capacity=None, token_mask=None,
              **kw):
        from ai_agent_kubectl_tpu_torch.parallel.moe import (
            default_capacity, ep_routes)

        torch = self.torch
        B, S, D = xs[0].shape
        T, ep = B * S, mesh.shape["expert"]
        T_l = T // ep if T % ep == 0 else T
        C = capacity or default_capacity(cfg, T_l)
        mask = (torch.ones((T,), device=xs[0].device) if token_mask is None
                else token_mask.reshape(T).float().to(xs[0].device))
        lost = []
        for e, i in enumerate(mesh.groups("expert")[0]):
            rows = slice(e * T_l, (e + 1) * T_l)
            slot, _ = ep_routes(cfg, lps[i]["router"],
                                xs[i].reshape(T, D)[rows], mask[rows], C)
            lost.append(((slot == cfg.n_experts * C)
                         & (mask[rows] > 0)[:, None]).any(dim=1))
        lost = torch.cat(lost)
        self.dropped += lost.sum()
        self.calls += 1
        out = self.real(cfg, lps, xs, mesh, capacity=capacity,
                        token_mask=token_mask, **kw)
        if self.captured is None and S > 1:
            self.captured = {"x": xs[0].clone(), "mask": mask.clone(),
                             "out": out[0].clone(), "lost": lost.clone(),
                             "router": lps[0]["router"].clone()}
        return out

    def read(self) -> int:
        return int(self.dropped)

    def restore(self) -> None:
        self.module.expert_parallel_moe = self.real


def phase_serve_moe_ep(torch) -> dict:
    """Phase 15d: Mixtral on expert and data meshes of one card."""
    release_served_apps(torch)
    try:
        return asyncio.run(_serve_moe_ep(torch))
    finally:
        release_served_apps(torch)


async def _serve_moe_ep(torch) -> dict:
    """Two random trees from seed 0 in turn: int4 attention with int8
    experts for (a), int8 throughout for (b)-(d) (the mesh serves int8);
    each serves the unsharded dense reference engine first, then its
    runs; transcripts gated where no prefill dropped a token, the first
    prefill dispatch of each run against ``dense_moe`` on its kept
    tokens."""
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.ops.quant import random_params_int8

    tag = "serve_moe_ep"
    mcfg = get_config(MOE_MODEL)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs, refs = {}, {}
    for quant, names in (("int4", ("ep1",)),
                         ("int8", ("tp2", "ep2", "dp2_ep2_tp2"))):
        t0 = time.monotonic()
        tree = random_params_int8(
            torch.Generator(device="cuda").manual_seed(0), mcfg,
            dtype=torch.bfloat16, quantize_embed=True,
            int4=quant == "int4", device="cuda")
        torch.cuda.synchronize()
        log(f"[{tag}] {mcfg.name}, {mcfg.n_layers} layers: random "
            f"{quant} tree drawn in {time.monotonic() - t0:.2f} s")
        ref = refs[quant] = await _moe_ep_run(torch, f"dense_{quant}",
                                              {"QUANT": quant}, tree, mcfg)
        for name in names:
            runs[name] = await _moe_ep_run(torch, name, MOE_EP_RUNS[name],
                                           tree, mcfg)
            _moe_ep_gate(torch, name, runs[name], ref, tree, mcfg)
        ref.pop("engine")
    if not any(r["gated"] for r in runs.values()):
        raise AssertionError(f"{tag}: every request dropped a token: no "
                             f"transcript gated")
        del tree
        release_served_apps(torch)
    peak = torch.cuda.max_memory_allocated() - base
    info = {"runs": {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("ids", "engine", "prompts")}
                     for k, v in runs.items()},
            "references": {k: {kk: vv for kk, vv in v.items()
                               if kk not in ("ids", "prompts")}
                           for k, v in refs.items()},
            "peak_gb": peak / 1e9,
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in _launch_counters()}}
    log(f"[{tag}] " + "; ".join(
        f"{k}: {v['seconds']:.1f} s, {v['tok_per_s']:.1f} tok/s, drops "
        f"{v['drops']} (startup {v['startup_drops']}), gated "
        f"{v['gated']} of {len(MOE_EP_QUERIES)}"
        for k, v in info["runs"].items())
        + f"; the dense references " + ", ".join(
            f"{k} {v['tok_per_s']:.1f} tok/s" for k, v in refs.items())
        + f" (shards on one card measure no interconnect: no claim); "
        f"peak {peak / 1e9:.1f} GB; {gpu_line()}")
    return info


async def _moe_ep_run(torch, name: str, env: dict, params, mcfg) -> dict:
    """One engine from the environment-style config (the mesh's devices
    on the one card) on ``params``, served over HTTP's app, the requests
    sent to it one at a time (greedy), each one's dropped tokens counted
    on its own; /health's sharding section and /metrics read after."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig
    from ai_agent_kubectl_tpu_torch.server.app import create_app

    tag = f"serve_moe_ep/{name}"
    port = _free_port()
    _phase_env(dict(MOE_EP_ENV, **env), port)
    cfg = ServiceConfig.from_env()
    n = MeshConfig.parse(cfg.mesh_shape).n_devices
    inner = BatchedTorchEngine.from_config(
        cfg, devices=[torch.device("cuda", 0)] * n if n > 1 else None)
    inner.params = params
    reference = not env.get("MESH_SHAPE") and not env.get("MOE_IMPL")
    drops = None if reference else _DropTap(torch)
    shards = _ShardTap(torch) if name == "dp2_ep2_tp2" else None
    runner = web.AppRunner(create_app(cfg, inner), access_log=None)
    t0 = time.monotonic()
    try:
        await runner.setup()             # starts the engine (warm-up too)
        site = web.TCPSite(runner, cfg.host, cfg.port)
        await site.start()
        startup_s = time.monotonic() - t0
        out = {"startup_s": startup_s, "regime": inner._attention_regime,
               "quant": inner.quant,
               "startup_drops": drops.read() if drops else 0}
        counters = _launch_counters()
        for fn in counters.values():
            fn.launches = 0
        prompts = [render_prompt(q) for q in MOE_EP_QUERIES]
        ids, per_request = [], []
        t_run = time.monotonic()
        for p in prompts:
            d0 = drops.read() if drops else 0
            res = await inner.generate(p, max_tokens=int(
                MOE_EP_ENV["MAX_NEW_TOKENS"]), temperature=0.0)
            ids.append(res.token_ids)
            per_request.append((drops.read() if drops else 0) - d0)
        seconds = time.monotonic() - t_run
        while inner._inflight:
            await asyncio.sleep(0.005)
        torch.cuda.synchronize()
        out.update(seconds=seconds, ids=ids, prompts=prompts,
                   tok_per_s=sum(len(i) for i in ids) / seconds,
                   drops=per_request,
                   launches={k: fn.launches for k, fn in counters.items()},
                   dispatches=drops.calls if drops else 0,
                   forward_steps=inner.forward_steps)
        if inner.kv_pool:
            check_pool_books(inner)
        url = f"http://{cfg.host}:{port}"
        async with aiohttp.ClientSession() as http:
            async with http.get(f"{url}/health") as r:
                out["sharding"] = (await r.json()).get("sharding")
            async with http.get(f"{url}/metrics") as r:
                out["metrics"] = _scrape(await r.text(), TP_FAMILIES)
    finally:
        if drops:
            drops.restore()
        if shards:
            shards.restore()
        await runner.cleanup()           # stops the engine
    if drops:
        out["captured"] = drops.captured
    if shards:
        # The last request's last decode step, on its data group's shard
        # (the requests come one at a time: the group's other slots idle).
        out["decode_positions"] = (
            [res.prompt_tokens + res.completion_tokens - 1]
            + [0] * (N_SLOTS // MESH_DP - 1))
        out["kernel_checks"] = shards.check(tag)
        shards.inputs.clear()
    log(f"[{tag}] {cfg.model_name} {cfg.mesh_shape or 'one device'} "
        f"(MOE_IMPL={cfg.moe_impl}, {inner.quant}): up in {startup_s:.1f} "
        f"s, regime {inner._attention_regime}; {len(ids)} requests in "
        f"{seconds:.2f} s; drops per request {per_request} (startup "
        f"{out['startup_drops']}); launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }")
    if reference:
        out["engine"] = inner            # its params: the near-tie forward
    inner._cache = None
    if not reference:
        inner.params = None
    release_served_apps(torch)
    return out


def _moe_ep_gate(torch, name: str, run: dict, ref: dict, params,
                 mcfg) -> None:
    """One run's gates: its kernel launched once per shard and layer of
    each forward, the dispatch where it serves, the fallback flags, the
    transcripts of requests none of whose prefill dropped a token equal
    to the dense reference's or apart first at a near tie, and the first
    prefill dispatch within LOGIT_RTOL of ``dense_moe`` over the tokens
    it kept."""
    from ai_agent_kubectl_tpu_torch.parallel.moe import dense_moe

    tag = f"serve_moe_ep/{name}"
    n, ep, kernel = MOE_EP_KERNELS[name]
    failures = []
    launched = run["launches"][kernel]
    if launched <= 0 or launched % (n * mcfg.n_layers):
        failures.append(f"{launched} {kernel} launches on {n} shards")
    if name == "ep1" and run["launches"]["qmatmul4"] <= 0:
        failures.append("no int4 launch on the one-device expert mesh")
    if name == "dp2_ep2_tp2":
        f = run["launches"]["flash_attention_cached"]
        if f <= 0 or f % (n * mcfg.n_layers):
            failures.append(f"{f} flash launches on {n} shards")
    if (run["dispatches"] > 0) is not ep:
        failures.append(f"{run['dispatches']} dispatches")
    fallback = name == "dp2_ep2_tp2"
    sh = run["sharding"] or {}
    if (sh.get("devices") != n
            or sh.get("kv_pool_mesh_fallback") is not fallback
            or sh.get("pool_sharded") is fallback
            or run["metrics"].get("kv_pool_mesh_fallback")
            != (1.0 if fallback else 0.0)):
        failures.append(f"/health {sh}, /metrics {run['metrics']}")
    engine = ref["engine"]
    gated = [i for i, d in enumerate(run["drops"])
             if d == 0 and run["startup_drops"] == 0]
    run["gated"] = len(gated)
    try:
        run["near_tie_mismatches"] = _spec_gate_mismatches(
            torch, tag, engine,
            [(engine.tokenizer.encode(run["prompts"][i]), 0.0, 0)
             for i in gated],
            [ref["ids"][i] for i in gated], [run["ids"][i] for i in gated])
    except AssertionError as e:
        failures.append(str(e))
    cap = run.pop("captured", None)
    if ep and cap is None:
        failures.append("no prefill dispatch captured")
    if cap is not None:
        routers = params["layers"]["router"]
        li = next(i for i in range(mcfg.n_layers)
                  if torch.equal(routers[i], cap["router"]))
        lp = {k: params["layers"][k][li] for k in ("router", "w_gate",
                                                   "w_up", "w_down")}
        with torch.no_grad():
            want = dense_moe(mcfg, lp, cap["x"]).reshape(-1, mcfg.dim)
        got = cap["out"].reshape(-1, mcfg.dim)
        kept = (cap["mask"] > 0) & ~cap["lost"]
        diff = (got[kept] - want[kept]).float()
        rms = float(want[kept].float().pow(2).mean().sqrt())
        err = float(diff.pow(2).mean().sqrt())
        run["dispatch_check"] = {
            "layer": li, "tokens": int(kept.sum()),
            "dropped_tokens": int(cap["lost"].sum()), "rms_err": err,
            "rms": rms, "max_abs_err": float(diff.abs().max())}
        if not int(kept.sum()) or err > LOGIT_RTOL * rms:
            failures.append(f"dispatch vs dense_moe {run['dispatch_check']}")
    if failures:
        raise AssertionError(f"{tag}: " + "; ".join(failures))
    log(f"[{tag}] gated {len(gated)} of {len(run['drops'])} transcripts "
        f"(near ties {len(run['near_tie_mismatches'])}); dispatch check "
        f"{run.get('dispatch_check')}")


# ---------------------------------------------------------- serve_ring

#: ring prefill on a seq axis of the one card: Llama-3-8B bf16 at full
#: width (random weights from seed 0) over MESH_SHAPE sp=2 and sp=2,tp=2,
#: the prompts past the largest bucket (1,024) prefilled by the ring
RING_MODEL = "llama-3-8b-instruct"
SERVE_RING_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda", "MODEL_NAME": RING_MODEL,
    "DTYPE": "bfloat16", "DECODE_BATCH_SIZE": str(N_SLOTS),
    "TOKENIZER_PATH": SERVE_ENV["TOKENIZER_PATH"],
    "RATE_LIMIT": "1000/minute", "MAX_SEQ_LEN": "8192",
    # Every prompt would take the suffix path with the prefix cache on.
    "HBM_PREFIX_CACHE": "false", "DECODE_ATTN": "paged",
    # DECODE_ATTN=auto's page for a GQA model; an explicit paged keeps
    # KV_PAGE_SIZE.
    "KV_PAGE_SIZE": "64", "MAX_NEW_TOKENS": "16",
}
#: run -> (MESH_SHAPE, shards on the card)
RING_RUNS = {"sp2": ("sp=2", 2), "sp2_tp2": ("sp=2,tp=2", 4)}
#: the two long queries' rendered lengths (padded to 4,096 and 8,192)
RING_LONG_TOKENS = (3000, 6000)
#: a seq axis that 4,096 does not divide: the ring falls back to chunks
RING_FALLBACK = ("sp=3", 3)
#: the dense ladder's span of serve_ring: MAX_SEQ_LEN 8192 and one
#: 16-token chunk, in pages of 64 (phase 2's row-4 geometry)
RING_DECODE_SPAN = -(-(8192 + 16) // 64) * 64
#: Llama-3-8B's tp=2 shard: 16 query heads over 4 KV heads of 128
LLAMA_TP2 = dict(H=LLAMA_HEADS // 2, KV=LLAMA_KV // 2, hd=LLAMA_HD)


def ring_decode_positions(kps: int) -> list:
    """8 slots near 3,000 and 6,000 (the serve_ring prompts' decode
    positions), on and beside the key-split boundaries nearest them."""
    out = []
    for near in (3000, 6000):
        b = max(1, round(near / kps)) * kps
        out += [b - 1, b, b + 1, near]
    return out


def _kernel_ring_decode(torch, gen) -> dict:
    """Row 4 as the decode after a ring prefill launches it on a shard of
    serve_ring (b): the dense cache of RING_DECODE_SPAN positions at
    Llama-3-8B's tp=2 shard, page 64, 8 slots near 3,000 and 6,000 on
    and beside a key-split boundary; against the plain version, then
    timed with its bound and SDPA over the live span."""
    import torch.nn.functional as F

    from ai_agent_kubectl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain, split_plan)

    splits, kps, _ = split_plan(N_SLOTS, LLAMA_TP2["H"], LLAMA_TP2["KV"],
                                RING_DECODE_SPAN)
    positions = ring_decode_positions(kps)
    case = paged_case(torch, gen, page=64, positions=positions,
                      span=RING_DECODE_SPAN, **LLAMA_TP2)["dense"]
    if splits < 2:
        raise AssertionError("paged ring decode: the keys must split")
    err = check_close(torch, "paged dense [llama_tp2_s8192]",
                      paged_decode_attention(**case),
                      paged_decode_attention_plain(**case))
    q, kc, vc, mask = paged_sdpa_inputs(torch, case, False)
    entry = timed(
        torch, lambda: paged_decode_attention(**case),
        lambda: paged_decode_attention_plain(**case),
        lambda: F.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, enable_gqa=True), iters=50)
    entry.update(positions=positions, splits=splits, keys_per_split=kps,
                 max_abs_err=err)
    with_bound(entry, *paged_live_work(case, False))
    log(f"[kernel] paged dense llama_tp2_s8192 (the decode after a ring "
        f"prefill, span {RING_DECODE_SPAN}): max |kernel - plain| = "
        f"{err:.3e} ({splits} key splits of {kps}; positions {positions})")
    log_timing(f"paged dense decode, Llama-3-8B tp=2 shard over "
               f"{RING_DECODE_SPAN} positions", entry, "sdpa")
    return entry


def phase_serve_ring(torch) -> dict:
    """Phase 15e: ring prefill on a seq axis of the one card."""
    release_served_apps(torch)
    out = asyncio.run(_serve_ring(torch))
    release_served_apps(torch)
    return out


def _dump_query(tokenizer, target: int) -> str:
    """A pasted ``kubectl get events`` dump of a large cluster, cut where
    the rendered prompt reaches ``target`` tokens (one line, as the
    service's sanitation leaves it)."""
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt

    head = "why do these pods keep failing? events:"
    lines, i = [], 0
    reasons = ("BackOff", "FailedScheduling", "Unhealthy", "OOMKilling",
               "FailedMount")
    while True:
        lines.append(f"{i % 59}m Warning {reasons[i % 5]} pod/web-{i:04d} "
                     f"node-{i % 37:02d} back-off restarting failed "
                     f"container web in payments-{i % 11}")
        i += 1
        if i % 2 == 0:
            query = " ".join([head] + lines)
            if len(tokenizer.encode(render_prompt(query))) >= target:
                return query


class _RingTap:
    """``_prefill_ring`` and ``_prefill_chunked`` of one engine, timed
    (the card synchronized around each call) with each call's prompt
    length and last-position logits kept, keyed by the prompt's token
    count; ``_prefill_ring``'s returning None (the chunked fallback) is
    counted."""

    def __init__(self, torch, engine):
        self.torch = torch
        self.calls: dict = {"ring": [], "chunked": []}
        for kind, name in (("ring", "_prefill_ring"),
                           ("chunked", "_prefill_chunked")):
            setattr(engine, name, self._wrap(kind, getattr(engine, name)))

    def _wrap(self, kind, real):
        torch = self.torch

        def call(prompt_ids, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = real(prompt_ids, *a, **kw)
            torch.cuda.synchronize()
            self.calls[kind].append({
                "n": len(prompt_ids), "ms": (time.monotonic() - t0) * 1e3,
                "logits": None if out is None else out[0][0].float().clone(),
                "fell_back": out is None})
            return out
        return call


def _logit_check(torch, got, want) -> dict:
    """serve_tp's rule: the rms of the difference within LOGIT_RTOL of
    the logits' rms, its max within TP_LOGIT_MAX of it."""
    rms = float(want.pow(2).mean().sqrt())
    diff = (got - want).float()
    out = {"rms": rms, "max_abs_err": float(diff.abs().max()),
           "rms_err": float(diff.pow(2).mean().sqrt()),
           "argmax_equal": bool(int(got.argmax()) == int(want.argmax()))}
    out["ok"] = bool(torch.isfinite(got).all()
                     and out["rms_err"] <= LOGIT_RTOL * rms
                     and out["max_abs_err"] <= TP_LOGIT_MAX * rms)
    return out


def _chunked_near_tie(torch, ref, ids, want, got) -> "dict | None":
    """Where ``got`` first leaves the reference's greedy ``want`` and the
    top-2 gap of the reference's own prefill of the prompt and the common
    prefix there (its ``_prefill_prompt``), against TP_LOGIT_MAX x the
    logits' rms: the largest logit error serve_tp's rule accepts between
    a sharded and an unsharded forward, so a smaller gap may flip (one
    bf16 step of a top logit near 10 is 0.0625, above LOGIT_RTOL x an
    rms near 1); None when they are equal."""
    want, got = list(want), list(got)
    if want == got:
        return None
    k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    with torch.no_grad():
        logits = ref._prefill_prompt(list(ids) + want[:k], 1)[0][0].float()
    rms = float(logits.pow(2).mean().sqrt())
    top2 = torch.topk(logits, 2).values
    return {"position": k, "gap": float(top2[0] - top2[1]),
            "tolerance": TP_LOGIT_MAX * rms}


def _dense_books(tag: str, inner) -> None:
    if any(s is not None for s in inner._slots) or \
            inner.stats().get("kv_pages_used"):
        raise AssertionError(f"{tag}: the books do not balance")


def _batcher_warnings():
    """A handler keeping the batcher's and the engine's warnings."""
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    keep = Keep()
    for name in ("ai_agent_kubectl_tpu_torch.engine.batcher",
                 "ai_agent_kubectl_tpu_torch.engine.torch_engine"):
        logging.getLogger(name).addHandler(keep)
    return keep


def _drop_warnings(keep) -> None:
    import logging

    for name in ("ai_agent_kubectl_tpu_torch.engine.batcher",
                 "ai_agent_kubectl_tpu_torch.engine.torch_engine"):
        logging.getLogger(name).removeHandler(keep)


async def _http_run(torch, tag: str, env: dict, params, devices, queries,
                    families, *, batched: bool = True, on_engine=None):
    """One engine from the environment-style config (the mesh's devices
    named), its weights handed over, served over HTTP: ``queries`` at
    once, counted in a window of their own (the pipe drained), then
    /health and /metrics. Returns (what was measured, the stopped
    engine)."""
    import aiohttp
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.service import status_for_text

    port = _free_port()
    _phase_env(env, port)
    cfg = ServiceConfig.from_env()
    cls = BatchedTorchEngine if batched else TorchEngine
    inner = cls.from_config(cfg, devices=devices)
    inner.params = params
    if on_engine is not None:
        on_engine(inner)
    engine = RecordingEngine(inner)
    keep = _batcher_warnings()
    runner = web.AppRunner(create_app(cfg, engine), access_log=None)
    t0 = time.monotonic()
    try:
        await runner.setup()             # starts the engine (warm-up too)
        site = web.TCPSite(runner, cfg.host, cfg.port)
        await site.start()
        out = {"startup_s": time.monotonic() - t0}
        log(f"[{tag}] {cfg.model_name} up in {out['startup_s']:.1f} s on "
            f"{inner.mesh.devices if inner.mesh else inner.device} (mesh "
            f"{cfg.mesh_shape or '-'})")
        counters = _launch_counters()
        url = f"http://{cfg.host}:{port}"
        async with aiohttp.ClientSession() as http:
            async def ask(query):
                async with http.post(f"{url}/kubectl-command",
                                     json={"query": query}) as r:
                    return r.status, await r.json()

            engine.results.clear()
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t_burst = time.monotonic()
            burst = await asyncio.gather(*[ask(q) for q in queries])
            out["burst_s"] = time.monotonic() - t_burst
            while getattr(inner, "_inflight", None):
                await asyncio.sleep(0.005)
            torch.cuda.synchronize()
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["launches"] = {n: fn.launches for n, fn in counters.items()}
            async with http.get(f"{url}/health") as r:
                out["sharding"] = (await r.json()).get("sharding")
            async with http.get(f"{url}/metrics") as r:
                out["metrics"] = _scrape(await r.text(), families)
        statuses = [s for s, _ in burst]
        want = [status_for_text(res.text) for _, res in engine.results]
        if sorted(statuses) != sorted(want) or len(engine.results) != \
                len(queries):
            raise AssertionError(f"{tag}: statuses {statuses}, the engine's "
                                 f"results {want}")
        out["results"] = {p: list(r.token_ids) for p, r in engine.results}
        tokens = sum(r.completion_tokens for _, r in engine.results)
        out["burst_tok_per_s"] = tokens / out["burst_s"]
        if batched:
            _dense_books(tag, inner)
    finally:
        await runner.cleanup()           # stops the engine
        _drop_warnings(keep)
    out["warnings"] = keep.lines
    return out, inner


async def _ring_reference(torch, params, prompts):
    """The unsharded engine on the same weights (the dense ladder: each
    long prompt prefilled in chunks through flash, row 3), at the
    engine: the queries' greedy token ids, each long prompt's chunked
    prefill (ms, last logits), the launches."""
    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine

    _phase_env(dict(SERVE_RING_ENV, KV_POOL="false"), _free_port())
    ref = BatchedTorchEngine.from_config(ServiceConfig.from_env())
    ref.params = params
    await ref.start()
    tap = _RingTap(torch, ref)
    counters = _launch_counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        got = await asyncio.gather(*[
            ref.generate(p, max_tokens=16, temperature=0.0)
            for p in prompts])
        tok_s = sum(r.completion_tokens for r in got) / (time.monotonic()
                                                          - t0)
        while ref._inflight:
            await asyncio.sleep(0.005)
        launches = {n: fn.launches for n, fn in counters.items()}
        ids = {p: list(r.token_ids) for p, r in zip(prompts, got)}
        chunked = {c["n"]: c for c in tap.calls["chunked"]}
    finally:
        await ref.stop()
    return ref, {"ids": ids, "chunked": chunked, "tok_per_s": tok_s,
                 "launches": launches}


async def _serve_ring(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.tokenizer import load_tokenizer
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params

    cfg = get_config(RING_MODEL)
    tokenizer = load_tokenizer(cfg, SERVE_ENV["TOKENIZER_PATH"])
    longs = [_dump_query(tokenizer, n) for n in RING_LONG_TOKENS]
    queries = longs + QUERIES[:6]
    long_ids = [tokenizer.encode(render_prompt(q)) for q in longs]
    if any(len(i) > 8192 - 16 for i in long_ids):
        raise AssertionError(f"serve_ring: prompts {[len(i) for i in long_ids]}"
                             f" past the cache")
    log(f"[serve_ring] long queries of {[len(i) for i in long_ids]} "
        f"rendered tokens (buckets up to 1024), six short ones")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    card = torch.device("cuda", 0)
    runs, taps = {}, {}
    tap = _ShardTap(torch)
    try:
        for name, (spec, n) in RING_RUNS.items():
            env = dict(SERVE_RING_ENV, MESH_SHAPE=spec)
            runs[name], inner = await _http_run(
                torch, f"serve_ring/{name}", env, full, [card] * n, queries,
                TP_FAMILIES, on_engine=lambda e, k=name: taps.__setitem__(
                    k, _RingTap(torch, e)))
            runs[name]["ring_prefills"] = inner.ring_prefills
            runs[name]["mesh"] = dict(inner.mesh.shape)
            runs[name]["decode"] = inner._decode_impl
            del inner
            release_served_apps(torch)
        # The long query once more through the single-sequence engine.
        env = dict(SERVE_RING_ENV, MESH_SHAPE="sp=2", DECODE_BATCH_SIZE="1")
        runs["single"], inner = await _http_run(
            torch, "serve_ring/single", env, full, [card] * 2, longs[1:],
            TP_FAMILIES, batched=False,
            on_engine=lambda e: taps.__setitem__("single",
                                                 _RingTap(torch, e)))
        runs["single"]["ring_prefills"] = inner.ring_prefills
        del inner
        # A seq axis that s_pad 4,096 does not divide: chunked prefill.
        spec, n = RING_FALLBACK
        env = dict(SERVE_RING_ENV, MESH_SHAPE=spec, DECODE_BATCH_SIZE="1")
        runs["fallback"], inner = await _http_run(
            torch, "serve_ring/fallback", env, full, [card] * n, longs[:1],
            TP_FAMILIES, batched=False,
            on_engine=lambda e: taps.__setitem__("fallback",
                                                 _RingTap(torch, e)))
        runs["fallback"]["ring_prefills"] = inner.ring_prefills
        del inner
        release_served_apps(torch)
    finally:
        tap.restore()
    checks = tap.check("serve_ring")
    tap.inputs.clear()
    ref, reference = await _ring_reference(
        torch, full, sorted(set().union(*(r["results"] for r in
                                          runs.values()))))
    peak = torch.cuda.max_memory_allocated() - base
    failures, ties, logit_checks = [], [], {}
    for name, r in runs.items():
        calls = taps[name].calls
        want_rings = {"sp2": 2, "sp2_tp2": 2, "single": 1,
                      "fallback": 0}[name]
        if r["ring_prefills"] != want_rings:
            failures.append(f"{name}: {r['ring_prefills']} ring prefills, "
                            f"expected {want_rings}")
        if name == "fallback" and not any(c["fell_back"]
                                          for c in calls["ring"]):
            failures.append(f"{name}: the ring did not fall back")
        firsts = {c["n"]: c for c in calls["ring"] if not c["fell_back"]}
        if name == "fallback":
            firsts = {c["n"]: c for c in calls["chunked"]}
        for n_tok, c in firsts.items():
            want = reference["chunked"].get(n_tok)
            if want is None:
                failures.append(f"{name}: no reference prefill of {n_tok}")
                continue
            chk = _logit_check(torch, c["logits"], want["logits"])
            chk.update(ms=c["ms"], reference_ms=want["ms"])
            logit_checks[f"{name}/{n_tok}"] = chk
            if not chk["ok"]:
                failures.append(f"{name}: first-token logits of the "
                                f"{n_tok}-token prompt {chk}")
        for prompt, got in r["results"].items():
            ids = ref.tokenizer.encode(prompt)
            gap = _chunked_near_tie(torch, ref, ids,
                                    reference["ids"][prompt], got)
            if gap is not None:
                if gap["gap"] > gap["tolerance"]:
                    failures.append(f"{name}: a transcript leaves the "
                                    f"reference's at {gap}, not a near tie")
                ties.append({"run": name, **gap})
        if name in RING_RUNS:
            sh = r["sharding"] or {}
            if (sh.get("mesh", {}).get("seq") != 2
                    or sh.get("kv_pool_mesh_fallback") is not True
                    or r["metrics"].get("kv_pool_mesh_fallback") != 1):
                failures.append(f"{name}: /health {sh}, /metrics "
                                f"{r['metrics']}")
            if not any("falling back to the dense KV ladder" in w
                       for w in r["warnings"]):
                failures.append(f"{name}: the pool fell back silently")
            if r["decode"] != "paged" or \
                    r["launches"]["paged_decode_attention"] <= 0 or \
                    r["launches"]["flash_attention_cached"] <= 0:
                failures.append(f"{name}: decode {r['decode']}, launches "
                                f"{r['launches']}")
    del full
    if failures:
        raise AssertionError("serve_ring: " + "; ".join(failures))
    rows = {k: [r["launches"]["paged_decode_attention"],
                r["launches"]["flash_attention_cached"]]
            for k, r in runs.items()}
    info = {"runs": {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("results", "warnings")}
                     for k, v in runs.items()},
            "logits": logit_checks, "near_ties": ties,
            "kernel_checks": checks, "peak_gb": peak / 1e9,
            "reference_tok_per_s": reference["tok_per_s"],
            "reference_launches": reference["launches"],
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in _launch_counters()}}
    log(f"[serve_ring] ring prefill against the unsharded chunked prefill "
        f"(ms): " + ", ".join(f"{k} {v['ms']:.1f} vs {v['reference_ms']:.1f}"
                             f" (logit rms err {v['rms_err']:.4f}, max "
                             f"{v['max_abs_err']:.4f} of rms {v['rms']:.3f})"
                             for k, v in logit_checks.items())
        + f"; {len(ties)} transcript(s) apart at a near tie; row 4 / row 3 "
        f"launches per run {rows}; bursts " + ", ".join(
            f"{k} {v['burst_tok_per_s']:.1f} tok/s" for k, v in runs.items())
        + f", the reference {reference['tok_per_s']:.1f} tok/s at the "
        f"engine (shards on one card: no claim); peak {peak / 1e9:.1f} GB "
        f"above the phase's start; {gpu_line()}")
    return info


# ------------------------------------------------------------ serve_pp

#: pipeline stages on one card: Llama-3-8B bf16 at full width (random
#: weights from seed 0) over MESH_SHAPE pp=2, pp=2,tp=2 and pp=2,tp=2
#: with int8 KV; DECODE_ATTN=paged asks for what the stages cannot read
SERVE_PP_ENV = {
    "ENGINE": "torch", "TORCH_DEVICE": "cuda", "MODEL_NAME": RING_MODEL,
    "DTYPE": "bfloat16", "DECODE_BATCH_SIZE": str(N_SLOTS),
    "TOKENIZER_PATH": SERVE_ENV["TOKENIZER_PATH"],
    "RATE_LIMIT": "1000/minute", "MAX_NEW_TOKENS": "16",
    "DECODE_ATTN": "paged", "KV_PAGE_SIZE": "64",
}
#: run -> (MESH_SHAPE, shards, extra knobs)
PP_RUNS = {"pp2": ("pp=2", 2, {}), "pp2_tp2": ("pp=2,tp=2", 4, {}),
           "pp2_tp2_int8": ("pp=2,tp=2", 4, {"KV_QUANT": "int8"})}
PP_PAGED_WARNING = ("paged decode attention does not compose with a pipe "
                    "mesh axis; falling back to dense")


def phase_serve_pp(torch) -> dict:
    """Phase 15f: pipeline stages on a pipe axis of the one card."""
    release_served_apps(torch)
    out = asyncio.run(_serve_pp(torch))
    release_served_apps(torch)
    return out


def _stage_bytes(inner) -> list:
    """(layers, parameter bytes, cache bytes) of each pipeline stage,
    each distinct tensor once; raises unless every shard of a stage holds
    L/pp layers of the weights and the cache."""
    from ai_agent_kubectl_tpu_torch.ops.quant import QuantKV

    mesh, cfg = inner.mesh, inner.model_cfg
    L = cfg.n_layers // mesh.pp
    out = []
    for s in range(mesh.pp):
        _, idx = mesh.select("pipe", s)
        seen, pbytes, cbytes = set(), 0, 0
        for i in idx:
            for t in _leaves(inner.params[i]):
                if t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    pbytes += t.numel() * t.element_size()
            if inner.params[i]["layers"]["wq"].shape[0] != L:
                raise AssertionError(f"stage {s} shard {i}: "
                                     f"{inner.params[i]['layers']['wq'].shape}")
            for leaf in (inner._cache.k, inner._cache.v):
                c = leaf.shards[i]
                parts = (c.q, c.s) if isinstance(c, QuantKV) else (c,)
                if any(p.shape[0] != L for p in parts):
                    raise AssertionError(f"stage {s} shard {i}: cache "
                                         f"{[p.shape for p in parts]}")
                cbytes += sum(p.numel() * p.element_size() for p in parts)
        out.append({"layers": L, "param_bytes": pbytes,
                    "cache_bytes": cbytes})
    return out


async def _pp_reference(torch, params, prompts, kv_quant: str) -> tuple:
    """The unsharded dense-ladder engine on the same weights, dense
    decode (the stages' attention), at the engine: greedy token ids and
    tok/s."""
    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine

    _phase_env(dict(SERVE_PP_ENV, KV_POOL="false", DECODE_ATTN="dense",
                    KV_QUANT=kv_quant), _free_port())
    ref = BatchedTorchEngine.from_config(ServiceConfig.from_env())
    ref.params = params
    await ref.start()
    try:
        t0 = time.monotonic()
        got = await asyncio.gather(*[
            ref.generate(p, max_tokens=16, temperature=0.0)
            for p in prompts])
        tok_s = sum(r.completion_tokens for r in got) / (time.monotonic()
                                                          - t0)
        while ref._inflight:
            await asyncio.sleep(0.005)
    finally:
        await ref.stop()
    return ref, {"ids": {p: list(r.token_ids) for p, r in zip(prompts, got)},
                 "tok_per_s": tok_s}


def _pp_step_logits(torch, params, cfg, ids, mesh=None, kv_quant=""):
    """One prefill step over a fresh dense cache: the logits at the last
    position."""
    from ai_agent_kubectl_tpu_torch.models.transformer import KVCache, forward

    n = len(ids)
    cache = KVCache.zeros(cfg, 1, n, dtype=torch.bfloat16, device="cuda",
                          kv_quant=kv_quant, mesh=mesh)
    with torch.no_grad():
        logits, _ = forward(params, cfg,
                            torch.tensor([ids], dtype=torch.int32,
                                         device="cuda"),
                            torch.arange(n, dtype=torch.int32,
                                         device="cuda")[None], cache,
                            logits_at=torch.tensor([n - 1], device="cuda"),
                            mesh=mesh)
    return logits[0, 0].float()


async def _serve_pp(torch) -> dict:
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params
    from ai_agent_kubectl_tpu_torch.parallel.pipeline import microbatch_count

    cfg = get_config(RING_MODEL)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    card = torch.device("cuda", 0)
    runs, failures, step = {}, [], {}
    refs = {}
    ids0 = None
    for name, (spec, n, extra) in PP_RUNS.items():
        env = dict(SERVE_PP_ENV, MESH_SHAPE=spec, **extra)
        runs[name], inner = await _http_run(
            torch, f"serve_pp/{name}", env, full, [card] * n, QUERIES,
            TP_FAMILIES)
        r = runs[name]
        r["stages"] = _stage_bytes(inner)
        r["microbatches"] = {"decode": microbatch_count(N_SLOTS, 2),
                             "admission": microbatch_count(1, 2)}
        r["decode"], r["kv_pool"] = inner._decode_impl, inner.kv_pool
        kvq = extra.get("KV_QUANT", "")
        log(f"[serve_pp/{name}] burst {r['burst_s']:.2f} s, "
            f"{r['burst_tok_per_s']:.1f} tok/s, decode {r['decode']}")
        if ids0 is None:
            ids0 = inner.tokenizer.encode(sorted(r["results"])[0])
        step[name] = _logit_check(
            torch, _pp_step_logits(torch, inner.params, cfg, ids0,
                                   inner.mesh, kvq),
            _pp_step_logits(torch, full, cfg, ids0, None, kvq))
        inner._cache = None
        del inner
        release_served_apps(torch)
        if kvq not in refs:
            t_ref = time.monotonic()
            refs[kvq] = await _pp_reference(torch, full,
                                            sorted(r["results"]), kvq)
            log(f"[serve_pp] reference (KV {kvq or 'bf16'}) in "
                f"{time.monotonic() - t_ref:.1f} s")
        ref, reference = refs[kvq]
        r["reference_tok_per_s"] = reference["tok_per_s"]
        r["near_ties"] = []
        for prompt, got in r["results"].items():
            gap = _chunked_near_tie(torch, ref, ref.tokenizer.encode(prompt),
                                    reference["ids"][prompt], got)
            if gap is not None:
                if gap["gap"] > gap["tolerance"]:
                    failures.append(f"{name}: a transcript leaves the "
                                    f"reference's at {gap}, not a near tie")
                r["near_ties"].append(gap)
        if not step[name]["ok"]:
            failures.append(f"{name}: one step's logits {step[name]}")
        sh = r["sharding"] or {}
        if (sh.get("mesh", {}).get("pipe") != 2
                or sh.get("kv_pool_mesh_fallback") is not True
                or r["metrics"].get("kv_pool_mesh_fallback") != 1
                or sh.get("residual_tp_fraction") != 0.0):
            failures.append(f"{name}: /health {sh}, /metrics {r['metrics']}")
        # The paged fallback's warning: the pipe's, or int8 KV's first
        # (the JAX engine's order).
        paged_warned = any(PP_PAGED_WARNING in w or (
            kvq and "DECODE_ATTN=paged does not read int8 KV" in w)
            for w in r["warnings"])
        if r["decode"] != "dense" or r["kv_pool"] or not paged_warned \
                or not any("KV_POOL does not compose" in w
                           for w in r["warnings"]):
            failures.append(f"{name}: decode {r['decode']}, pool "
                            f"{r['kv_pool']}, warnings {r['warnings']}")
        if any(v for k, v in r["launches"].items()):
            failures.append(f"{name}: a kernel launched inside a stage "
                            f"{r['launches']}")
    peak = torch.cuda.max_memory_allocated() - base
    del full, refs
    if failures:
        raise AssertionError("serve_pp: " + "; ".join(failures))
    info = {"runs": {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("results", "warnings")}
                     for k, v in runs.items()},
            "step_logits": step, "peak_gb": peak / 1e9,
            "launches": {n: sum(r["launches"][n] for r in runs.values())
                         for n in _launch_counters()}}
    log(f"[serve_pp] stages: " + "; ".join(
        f"{k} " + ", ".join(f"{s['layers']} layers, {s['param_bytes'] / 1e9:.2f}"
                            f" GB params, {s['cache_bytes'] / 1e9:.2f} GB KV"
                            for s in v["stages"])
        for k, v in runs.items())
        + f"; microbatches {runs['pp2']['microbatches']}; one step's "
        f"logits " + ", ".join(f"{k} rms err {v['rms_err']:.4f} max "
                               f"{v['max_abs_err']:.4f} (rms {v['rms']:.3f})"
                               for k, v in step.items())
        + "; bursts " + ", ".join(
            f"{k} {v['burst_tok_per_s']:.1f} tok/s (reference "
            f"{v['reference_tok_per_s']:.1f} at the engine)"
            for k, v in runs.items())
        + f" (one card carries every stage: no claim); peak "
        f"{peak / 1e9:.1f} GB above the phase's start; {gpu_line()}")
    return info


# ----------------------------------------------------------- serve_dcn

DCN_MODEL = "llama-3-8b-instruct"
#: both rank processes' environment: each adds ENGINE, DCN_MESH_SHAPE,
#: its PROCESS_ID and PORT, and the coordinator's address
SERVE_DCN_ENV = {
    "TORCH_DEVICE": "cuda", "MODEL_NAME": DCN_MODEL, "DTYPE": "bfloat16",
    "TOKENIZER_PATH": SERVE_ENV["TOKENIZER_PATH"],
    "RATE_LIMIT": "1000/minute", "MAX_NEW_TOKENS": "16",
    "MESH_SHAPE": "tp=2", "NUM_PROCESSES": "2",
}
#: each rank's two shards, on the one card
DCN_DEVICES = ("cuda:0", "cuda:0")
#: run -> (ENGINE, DECODE_BATCH_SIZE, DCN_MESH_SHAPE, the one-process
#: MESH_SHAPE with the same shards in the same order, queries). A data
#: axis takes the pool away (the JAX engine's rule), so the batched run
#: joins the processes on the model axis: the pool, each rank's ragged
#: kernel on its two shards; the single-sequence run on the data axis.
#: Four slots for four queries: every join of a ragged prologue carries
#: each slot's window across the processes.
DCN_RUNS = {"batched": ("torch-batched", 4, "tp=2", "tp=4", QUERIES[:4]),
            "single": ("torch", 1, "dp=2", "dp=2,tp=2", QUERIES[:1])}
#: (a): rows x columns of the forward whose batch crosses the process
#: boundary (tp=2 x DCN dp=2), flash prefill per shard
DCN_FORWARD = (4, 128)
#: seconds a rank process may take to start serving, and to exit
DCN_START_S, DCN_EXIT_S = 300.0, 60.0


def phase_serve_dcn(torch) -> dict:
    """Phase 15g: two processes over gloo on the one card."""
    release_served_apps(torch)
    out = asyncio.run(_serve_dcn(torch))
    release_served_apps(torch)
    return out


def dcn_rank(torch) -> int:
    """One rank process of serve_dcn (``--rank-of serve_dcn``): the cut
    model, (a)'s forward where ``DCN_FORWARD_OUT`` names its directory,
    then the port's server entry point on two shards of the card."""
    from ai_agent_kubectl_tpu_torch.server.__main__ import main as serve

    out = os.environ.get("DCN_FORWARD_OUT")
    with phase_layers("serve_dcn"):
        if out:
            _dcn_forward(torch, Path(out))
        serve(["--devices", ",".join(DCN_DEVICES)])
    return 0


def _dcn_inputs(torch, cfg) -> tuple:
    rows, cols = DCN_FORWARD
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (rows, cols), generator=gen,
                           device="cuda", dtype=torch.int32)
    positions = torch.arange(cols, dtype=torch.int32,
                             device="cuda")[None].expand(rows, cols)
    return tokens, positions.contiguous()


def _dcn_forward_run(torch, params, cfg, mesh, reps: int = 3) -> tuple:
    """(a)'s forward over ``mesh`` (a prefill, flash per shard): the
    logits at each row's last column (None on a rank other than 0 of a
    mesh over processes), and ms per forward over ``reps`` more (a fresh
    cache each)."""
    from ai_agent_kubectl_tpu_torch.models.transformer import KVCache, forward

    rows, cols = DCN_FORWARD
    tokens, positions = _dcn_inputs(torch, cfg)
    last = torch.full((rows,), cols - 1, dtype=torch.int64, device="cuda")

    def once():
        cache = KVCache.zeros(cfg, rows, cols, dtype=torch.bfloat16,
                              device="cuda", mesh=mesh, split_rows=True)
        with torch.no_grad():
            return forward(params, cfg, tokens, positions, cache,
                           kv_limit=cols, attn_impl="flash",
                           logits_at=last, mesh=mesh)[0]

    logits = once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    torch.cuda.synchronize()
    return logits, (time.perf_counter() - t0) * 1e3 / max(1, reps)


def _dcn_forward(torch, out: Path) -> None:
    """(a) in a rank process: the group joined, tp=2 x DCN dp=2 over
    both processes, the seeded weights' own shards, the forward; its
    logits and ms saved for the phase."""
    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params
    from ai_agent_kubectl_tpu_torch.parallel import distributed
    from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

    rank = int(os.environ["PROCESS_ID"])
    distributed.init_distributed(os.environ["COORDINATOR_ADDRESS"], 2, rank)
    cfg = get_config(DCN_MODEL)
    mesh = build_mesh(MeshConfig.parse("tp=2"),
                      distributed.global_devices(list(DCN_DEVICES)),
                      dcn=MeshConfig.parse("dp=2"))
    full = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    params = shard_params(full, mesh, cfg)
    del full
    logits, ms = _dcn_forward_run(torch, params, cfg, mesh)
    if logits is not None:
        torch.save(logits.cpu(), out / f"forward-{rank}.pt")
    (out / f"forward-{rank}.json").write_text(json.dumps(
        {"ms": ms, "owners": list(mesh.owners), "local": mesh.local_shards,
         "logits": logits is not None}))
    del params, logits
    torch.cuda.empty_cache()


def _sse_text(body: str) -> tuple:
    """(a stream's token pieces joined, its last event)."""
    pieces, last = [], None
    for frame in body.split("\n\n"):
        if not frame.strip():
            continue
        lines = frame.split("\n")
        event = next((ln[7:] for ln in lines if ln.startswith("event: ")),
                     None)
        if event is None:
            pieces.append("\n".join(ln[6:] for ln in lines
                                    if ln.startswith("data: ")))
        last = event
    return "".join(pieces), last


async def _dcn_http(url: str, queries=(), burst=()) -> dict:
    """Over ``/kubectl-command/stream``: each of ``queries`` alone, in
    turn (its transcript: one admission alone, so that every server
    compared runs the same shapes), then ``burst`` at once (seconds),
    then /health and /metrics (the books' families)."""
    import aiohttp

    async with aiohttp.ClientSession() as http:
        async def ask(q):
            async with http.post(f"{url}/kubectl-command/stream",
                                 json={"query": q}) as r:
                return _sse_text(await r.text())

        got = [await ask(q) for q in queries]
        t0 = time.monotonic()
        ends = await asyncio.gather(*[ask(q) for q in burst])
        burst_s = time.monotonic() - t0
        async with http.get(f"{url}/health") as r:
            health = await r.json()
        async with http.get(f"{url}/metrics") as r:
            metrics = _scrape(await r.text(), (
                "engine_batch_occupancy", "engine_queue_depth",
                "mesh_devices"))
    return {"texts": {q: t for q, (t, _) in zip(queries, got)},
            "events": [e for _, e in got + list(ends)], "burst_s": burst_s,
            "sharding": health.get("sharding"),
            "kv_pool": health.get("kv_pool"), "metrics": metrics}


def _dcn_burst_queries(queries) -> list:
    """The burst's queries: others than the transcripts' (a command the
    safety parse passes is cached by its query)."""
    return [f"{q} right now" for q in queries]


def _port_open(port: int) -> bool:
    import socket

    with socket.socket() as s:
        s.settimeout(1.0)
        return s.connect_ex(("127.0.0.1", port)) == 0


async def _dcn_pair(torch, name: str, work: Path) -> dict:
    """Two rank processes of one run: started together, rank 0 asked
    over HTTP once it is ready, then stopped; both exits and reports."""
    import signal

    import aiohttp

    engine, batch, dcn, _, queries = DCN_RUNS[name]
    coord = f"127.0.0.1:{_free_port()}"
    ports = [_free_port(), _free_port()]
    procs, logs = [], []
    for r in range(2):
        env = dict(START_ENV, **SERVE_DCN_ENV, ENGINE=engine,
                   DECODE_BATCH_SIZE=str(batch), DCN_MESH_SHAPE=dcn,
                   COORDINATOR_ADDRESS=coord, PROCESS_ID=str(r),
                   HOST="127.0.0.1", PORT=str(ports[r]),
                   OMP_NUM_THREADS="4")
        if name == "batched":
            env["DCN_FORWARD_OUT"] = str(work)
        out = open(work / f"{name}-{r}.out", "w")
        err = open(work / f"{name}-{r}.err", "w")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-of",
             "serve_dcn"], env=env, stdout=out, stderr=err, cwd=str(ROOT)))
    url = f"http://127.0.0.1:{ports[0]}"
    t0 = time.monotonic()
    res: dict = {}
    try:
        async with aiohttp.ClientSession() as http:
            while True:
                if any(p.poll() is not None for p in procs):
                    raise AssertionError(f"serve_dcn/{name}: a rank ended "
                                         f"before serving")
                if time.monotonic() - t0 > DCN_START_S:
                    raise AssertionError(f"serve_dcn/{name}: rank 0 did not "
                                         f"answer /health engine_ready "
                                         f"within {DCN_START_S:.0f} s")
                try:
                    async with http.get(f"{url}/health") as r:
                        if (await r.json()).get("engine_ready"):
                            break
                except (aiohttp.ClientError, ValueError):
                    pass
                await asyncio.sleep(0.25)
        res["startup_s"] = time.monotonic() - t0
        res["rank1_port_open"] = _port_open(ports[1])
        res.update(await _dcn_http(url, queries,
                                   _dcn_burst_queries(queries)))
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGTERM)
        end = time.monotonic() + DCN_EXIT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError(f"serve_dcn/{name}: a rank did not "
                                     f"exit within {DCN_EXIT_S:.0f} s of "
                                     f"rank 0's stop")
        for out, err in logs:
            out.close()
            err.close()
    res["exits"] = [p.returncode for p in procs]
    res["pair_s"] = time.monotonic() - t0
    res["reports"] = []
    for r in range(2):
        lines = (work / f"{name}-{r}.out").read_text().strip().splitlines()
        res["reports"].append(json.loads(lines[-1]) if lines else None)
        if procs[r].returncode != 0:
            log((work / f"{name}-{r}.err").read_text()[-3000:])
    return res


async def _dcn_one_process(torch, name: str, params, batched: bool) -> dict:
    """A run's references on the same weights, in this process: the
    one-process mesh (its shards in the same order, on the card) and the
    unsharded engine, each asked each query alone in turn through
    ``generate`` (token ids and text); then the mesh served over HTTP and
    sent the pair's burst."""
    from aiohttp import web

    from ai_agent_kubectl_tpu_torch.config import ServiceConfig
    from ai_agent_kubectl_tpu_torch.engine.batcher import BatchedTorchEngine
    from ai_agent_kubectl_tpu_torch.engine.prompts import render_prompt
    from ai_agent_kubectl_tpu_torch.engine.torch_engine import TorchEngine
    from ai_agent_kubectl_tpu_torch.server.app import create_app
    from ai_agent_kubectl_tpu_torch.server.sanitize import sanitize_query

    engine, batch, _, spec, queries = DCN_RUNS[name]
    cls = BatchedTorchEngine if batched else TorchEngine
    prompts = {q: render_prompt(sanitize_query(q)) for q in queries}
    out = {}
    for tag, mesh_spec, n in (("mesh", spec, 4), ("unsharded", "", 1)):
        port = _free_port()
        _phase_env(dict(SERVE_DCN_ENV, ENGINE=engine,
                        DECODE_BATCH_SIZE=str(batch), MESH_SHAPE=mesh_spec,
                        NUM_PROCESSES="1"), port)
        cfg = ServiceConfig.from_env()
        inner = cls.from_config(
            cfg, devices=[torch.device("cuda", 0)] * n if n > 1 else None)
        inner.params = params
        runner = web.AppRunner(create_app(cfg, inner), access_log=None)
        got = {"ids": {}, "texts": {}}
        try:
            await runner.setup()             # starts the engine
            await web.TCPSite(runner, cfg.host, port).start()
            for q in queries:
                r = await inner.generate(prompts[q], max_tokens=16,
                                         temperature=0.0)
                got["ids"][q], got["texts"][q] = list(r.token_ids), r.text
            if tag == "mesh":
                got["burst_s"] = (await _dcn_http(
                    f"http://127.0.0.1:{port}",
                    burst=_dcn_burst_queries(queries)))["burst_s"]
        finally:
            await runner.cleanup()           # stops the engine
        if tag == "unsharded":
            got["near_ties"] = [
                _chunked_near_tie(torch, inner,
                                  inner.tokenizer.encode(prompts[q]),
                                  got["ids"][q], out["mesh"]["ids"][q])
                for q in queries]
        inner._cache = None
        del inner
        release_served_apps(torch)
        out[tag] = got
    return out


async def _serve_dcn(torch) -> dict:
    import tempfile

    from ai_agent_kubectl_tpu_torch.models.config import get_config
    from ai_agent_kubectl_tpu_torch.models.transformer import init_params
    from ai_agent_kubectl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ai_agent_kubectl_tpu_torch.parallel.sharding import shard_params

    work = Path(tempfile.mkdtemp(prefix="serve_dcn-"))
    t_phase = time.monotonic()
    failures = []
    runs = {name: await _dcn_pair(torch, name, work) for name in DCN_RUNS}
    # (a) against the one-process mesh on the card, in the same shard
    # order, on the same seeded weights; run twice to show its own
    # determinism.
    cfg = get_config(DCN_MODEL)
    full = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                       dtype=torch.bfloat16, device="cuda")
    mesh = build_mesh(MeshConfig.parse("dp=2,tp=2"),
                      [torch.device("cuda", 0)] * 4)
    sharded = shard_params(full, mesh, cfg)
    one, one_ms = _dcn_forward_run(torch, sharded, cfg, mesh)
    again, _ = _dcn_forward_run(torch, sharded, cfg, mesh, reps=0)
    del sharded
    # Only rank 0 samples, so only rank 0 receives the logits.
    ranks = [json.loads((work / f"forward-{r}.json").read_text())
             for r in range(2)]
    got = torch.load(work / "forward-0.pt").to("cuda")
    fwd = {"ms": [r["ms"] for r in ranks], "one_process_ms": one_ms,
           "logits_on_rank": [r["logits"] for r in ranks],
           "equal_one_process": bool(torch.equal(got, one)),
           "one_process_deterministic": bool(torch.equal(one, again)),
           "max_abs_err": float((got.float() - one.float()).abs().max()),
           "finite": bool(torch.isfinite(got).all())}
    if not (fwd["logits_on_rank"] == [True, False]
            and fwd["equal_one_process"] and fwd["finite"]):
        failures.append(f"(a) forward {fwd}")
    del one, again, got
    refs = {}
    t_refs = time.monotonic()
    for name, (engine, _, dcn, spec, queries) in DCN_RUNS.items():
        r = runs[name]
        refs[name] = ref = await _dcn_one_process(
            torch, name, full, batched=engine == "torch-batched")
        mine = ref["mesh"]
        # (b)/(f): byte-identical to the one-process mesh; against the
        # unsharded engine equal or at a near tie
        if r["texts"] != mine["texts"]:
            failures.append(f"{name}: transcripts {r['texts']} != the "
                            f"one-process mesh's {mine['texts']}")
        for gap in ref["unsharded"]["near_ties"]:
            if gap is not None and gap["gap"] > gap["tolerance"]:
                failures.append(f"{name}: leaves the unsharded engine at "
                                f"{gap}, not a near tie")
        if any(e not in ("done", "error") for e in r["events"]):
            failures.append(f"{name}: stream ends {r['events']}")
        # (c) the books on rank 0; (e) both exits; rank 1 binds no port
        m = r["metrics"]
        if m.get("engine_batch_occupancy") or m.get("engine_queue_depth"):
            failures.append(f"{name}: books {m}")
        pool = r.get("kv_pool")
        if name == "batched" and (
                not pool or pool["live"] != 0
                or pool["free"] + pool["cached"] != pool["n_blocks"]):
            failures.append(f"{name}: the pool's books {pool}")
        if r["exits"] != [0, 0] or r["rank1_port_open"]:
            failures.append(f"{name}: exits {r['exits']}, rank 1 port open "
                            f"{r['rank1_port_open']}")
        # (d)/(f): each rank's own launches of the path's kernel while
        # it served, its engine's start apart (the report's launches)
        kernel = ("ragged_attention_pool_sharded" if name == "batched"
                  else "flash_attention_cached")
        counts = [rep["launches"][kernel] if rep else 0
                  for rep in r["reports"]]
        if min(counts) <= 0:
            failures.append(f"{name}: {kernel} launches per rank {counts}")
        sh = r["sharding"] or {}
        if sh.get("devices") != 4 or (name == "batched"
                                      and m.get("mesh_devices") != 4):
            failures.append(f"{name}: /health sharding {sh}, /metrics {m}")
    del full
    if failures:
        raise AssertionError("serve_dcn: " + "; ".join(failures))
    info = {"forward": fwd, "seconds": time.monotonic() - t_phase,
            "references_s": time.monotonic() - t_refs,
            "runs": {}, "launches": {}}
    for name, r in runs.items():
        rep0 = r["reports"][0]
        one_s = refs[name]["mesh"]["burst_s"]
        info["runs"][name] = {
            "startup_s": r["startup_s"], "burst_s": r["burst_s"],
            "one_process_burst_s": one_s,
            "burst_ratio": r["burst_s"] / one_s,
            "pair_s": r["pair_s"], "calls": rep0["calls"],
            "ms_per_call_post": 1e3 * rep0["post_s"] / max(1, rep0["calls"]),
            "traffic_per_rank": [rep["traffic"] for rep in r["reports"]],
            "launches_per_rank": [rep["launches"] for rep in r["reports"]],
            "launches_at_start_per_rank": [rep["launches_at_start"]
                                           for rep in r["reports"]],
            "regime": (r["sharding"] or {}).get("attention_regime")}
    for n in _launch_counters():
        info["launches"][n] = sum(rep["launches"].get(n, 0)
                                  for r in runs.values()
                                  for rep in r["reports"])
    log("[serve_dcn] (a) forward 4x128 over tp=2 x DCN dp=2: logits on "
        f"ranks {fwd['logits_on_rank']}, = one-process mesh "
        f"{fwd['equal_one_process']}"
        f"; {fwd['ms'][0]:.1f} ms a forward in two processes vs "
        f"{fwd['one_process_ms']:.1f} ms in one; " + "; ".join(
            f"{k} burst {v['burst_s']:.2f} s vs {v['one_process_burst_s']:.2f}"
            f" s in one process ({v['burst_ratio']:.2f}x), {v['calls']} calls"
            f" at {v['ms_per_call_post']:.2f} ms posting each, traffic per "
            f"rank " + str([{kk: round(vv, 4) for kk, vv in t.items()}
                            for t in v['traffic_per_rank']])
            + ", launches per rank while serving " + str(
                [{kk: vv for kk, vv in lp.items() if vv}
                 for lp in v['launches_per_rank']])
            + f", the pair {v['pair_s']:.1f} s (startup "
            f"{v['startup_s']:.1f})" for k, v in info["runs"].items())
        + f"; references {info['references_s']:.1f} s; phase "
        f"{info['seconds']:.1f} s; {gpu_line()}")
    return info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each serving run, profile one more burst; "
                    "in the timing phase, split each kernel call into the "
                    "kernels it launches")
    ap.add_argument("--bursts", type=int, default=1,
                    help="bursts of 8 fresh queries the serve phase times "
                    "(the first is the counted one)")
    ap.add_argument("--rank-of", choices=("serve_dcn",),
                    help="run as one rank process of that phase (the "
                    "phase starts them)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not (ROOT / PACKAGE / "__init__.py").is_file():
        log(f"{PACKAGE}/ is not beside {Path(__file__).name}: run this "
            f"script from a checkout of the repository")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke run needs a "
            "CUDA device")
        return 2
    sys.path.insert(0, str(ROOT))
    if args.rank_of:
        return dcn_rank(torch)
    # Every float32 comparison on the card runs in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    results: dict = {}
    t_all = time.monotonic()
    t_phase = [t_all]
    faulthandler.dump_traceback_later(STACKS_AT_S, exit=False)

    def run(name: str, fn, *args) -> None:
        if name not in phases:
            return
        with phase_layers(name):
            results[name] = fn(*args)
        now = time.monotonic()
        log(f"[time] {name} {now - t_phase[0]:.1f} s ({now - t_all:.1f} s "
            f"in all)")
        t_phase[0] = now

    run("build", phase_build)
    run("kernel", phase_kernel, torch)
    run("serve", phase_serve, torch, args.profile, args.bursts)
    run("serve_pipe", phase_serve_pipe, torch)
    run("serve1", phase_serve1, torch, args.profile)
    run("serve_paged", phase_serve_paged, torch, args.profile)
    run("serve_ckpt", phase_serve_ckpt, torch, results.get("serve", {}))
    run("serve_qos", phase_serve_qos, torch)
    run("serve_moe", phase_serve_moe, torch, args.profile)
    run("serve_kvq", phase_serve_kvq, torch, args.profile)
    run("serve_obs", phase_serve_obs, torch, results.get("serve", {}))
    run("serve_chaos", phase_serve_chaos, torch)
    run("serve_grammar", phase_serve_grammar, torch, results.get("serve", {}))
    run("serve_spec", phase_serve_spec, torch)
    run("serve_host", phase_serve_host, torch)
    run("serve_fleet", phase_serve_fleet, torch, results.get("serve", {}))
    run("serve_tp", phase_serve_tp, torch)
    run("serve_spec_tp", phase_serve_spec_tp, torch)
    run("serve_moe_ep", phase_serve_moe_ep, torch)
    run("serve_ring", phase_serve_ring, torch)
    run("serve_pp", phase_serve_pp, torch)
    run("serve_dcn", phase_serve_dcn, torch)
    run("timing", phase_timing, torch, results.get("serve", {}),
        results.get("serve_paged", {}), results.get("serve_moe", {}),
        results.get("serve_spec", {}), results.get("serve_host", {}),
        results.get("serve_tp", {}), args.profile,
        results.get("serve_spec_tp", {}), results.get("serve_moe_ep", {}))
    faulthandler.cancel_dump_traceback_later()
    log(f"[done] phases {phases} in {time.monotonic() - t_all:.1f} s")

    print(json.dumps({"kernels": kernel_lines(results)}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
