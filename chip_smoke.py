#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --k1-timings``, ``--k2-timings`` and
``--k4-timings`` time K1, K2 or K4 alone: see k1_alone, k2_alone and
k4_alone; ``--fit-spread`` makes path 9 (c)'s m-64 fits once: see
fit_spread; ``--dryrun-smoke`` prints path 15 (c)'s fake traces, which
path 15 runs in a subprocess: see dryrun_smoke; ``--dryrun-serve``
prints the dry-run of path 16's cuts, likewise: see dryrun_serve;
``--custom-op-timings`` times K5, K6 and the aggregate alone: see
custom_op_timings.)

Phases (any failure exits nonzero; no phase's failure is caught):
  1. device   CUDA must be present; prints the card's name and power limit.
  2. build    builds every CUDA kernel of the port (K1, K2, K3, K4, K5,
              K6 and the GIN aggregate) from the checkout's sources, one
              nvcc per source, all at once (sm_90a), and times the build.
  3. edges    each kernel against its plain PyTorch version on edge
              cases. K1's gathered entry (every call also repeated, bit
              for bit): ragged C, masked slots, k > #finite, exact int8
              ties, a deep merge, runs of many chunks a block at k 1,
              256 and 1024, a batch of one query over 400,000 slots,
              int32 codes at K 512 and 1024 (M 8 and 6, k = 1 and k =
              C). K1's cell-major entry, on its cells' fills and on the
              candidate ids, against its plain version and bit for bit
              against the gathered entry on the gathered inputs: empty
              cells, ragged Q and Q 1, cand wider and narrower than
              P * max_cell, k past a cell, int32 codes (K 1024, M 8 and
              6), posting lists with holes (ids only). K2 (every call also repeated, bit for
              bit): ragged N, k > N, Q = 1, Q = 3 at k = 1, M not a
              multiple of 16, a large k, k = N + 3, exact int8 ties, int8
              entries of +-127 at M = 300 (the 16-bit lanes flushed
              mid-row), N = 1,000,000, int32 codes at K 512 and 1024
              (k = 1 and k = N).
              K4: N = 1, 2, ragged N, N = 2048, a multi-tile N, repeated
              values, tau = 0 and tau = +inf; its fused entry at the same
              N (20,000 on its global-scratch route) with k_pairs 1, the
              fit's b 80 and all pairs: tau bit-equal to
              find_quantile_threshold's, count and coeff equal. K5 (f32 and bf16): S = 1,
              16, 80 (ragged), 4096; G = 1 and 8; dh = 8 to 256; window
              16 at S = 1000, a window wider than S, window 1 (bf16 on the
              tensor-core kernel, f32 on the CUDA-core one); and at bf16
              TinyLlama's heads at S = 32768 and Gemma3-4B's local layers
              (H 8 / KV 4 / dh 256, window 1024) at S = 8192. K6 (f32
              on the CUDA-core kernel, bf16 on the tensor-core one, each
              launch counted on its route): T = 1, 63, 4096 with D x V of
              64 x 256 (with and without a masked tail), 64 x 1000, 2048 x
              1000 (masked) and 2048 x 32000; int32 labels; a tied head (D
              contiguous); and Gemma3-4B's tied head embed.T (2560,
              262144) at T = 512.
              K3 (exact k-NN): Q = 1 and ragged Q; N = 1, N under a
              tile, ragged N; k = 1, k = N, k > N, k 512, 513, 1500 and
              4096 (lists in shared memory, then in global scratch),
              k = N + 3; D = 1, 19, 38, 64, 384; duplicate rows and
              queries; small-integer data (bit-equal, ties included) in
              f32 and bf16; bf16 inputs; N = 1,000,000 at D = 384;
              Q = 1,000,000 against N = 2048; one call repeated, bit for
              bit. The GIN aggregate (csr_gather_sum, both orders of each
              graph, bit-equal to its plain version on the host and
              repeated bit for bit): ragged power-law degrees with empty
              rows, masks 0, 1 and 0.37, F 1, 31, 64, 100 and 1433; a
              20,000-edge destination row and a 20,000-edge source row;
              a graph with no edges; f64 input raises.
  4. path 1   the ivfpq path at full size: build_engine over a
              1,000,000 x 384 clustered f32 corpus made with numpy from a
              seed, spec qpad64>ivf1024x16>pq16x256:i8@kernel>rr64, then
              searches of 1, 8, 64 and 256 queries (k=10). Launch counts
              are zeroed just before and read just after; recall@10 is
              held against exact search on the card, and the same engine
              with @jnp must return the same ids. Which K1 entry each
              batch launched (k1_entries: the padded scan the cell-major
              one, a compact bucket the gathered one).
  5. K1 main  K1's two entries against their plain versions on path 1's
              own scan inputs (batch 256) at f32, bf16 and int8.
  6. timings  the gather and K1's two entries at batch 256 (k1_time),
              their plain versions, plans and bounds, the L2 read rate;
              per-stage search times.
  7. trace    the card's busy share while searching (torch.profiler).
              Then F2: k-means of path 1's reduced 1M x 64 vectors into its
              1024 cells, twice from the same rows: centroids bit for bit.
  8. path 2   the pq and opq kinds on the same corpus: build_engine with
              spec qpad64>pq16x256:i8@kernel>rr64 and the QPAD fit on
              MPADConfig(backend="kernel") (K4's fused entry; counts
              zeroed just before the build and read just after: 64 x 48
              = 3,072 launches, none of the entry at a given tau),
              then an opq index over the same reduced corpus and reducer
              (get_ops("opq").build, SearchEngine.from_state). Both
              engines search 1, 8, 64 and 256 queries (K2 counted the
              same way); recall@10 against exact search, and @jnp must
              return the @kernel ids.
  9. K2, K4 main  K2 against its plain version on path 2's own tables and
              codes (batch 256, f32, bf16, int8); the kernel backend's phi
              value and gradient against the fast backend's on the fit
              sample; the fused K4 on the sample's projections; a fit of
              8 x 48 steps fused and on the two-step route (bisection,
              then K4 at tau): directions bit for bit.
  10. timings K2 (int8 at batches 1, 8, 64 and 256, f32 and bf16 at
              256, each a call's time, its kernels' device time, its
              bound and the plan it launched: queries a block, occupancy,
              row parts, waves) and K4 (fused and at a given tau, the
              launch floor, kernel launches a fit step) beside their
              plain versions and bounds; p50 latency and QPS of the pq and opq engines; the
              pq build's stage times. Then F3: pq8x1024:i8@kernel>rr64 (int32 codes
              through K2) on the first 200,000 rows, searched at every
              batch: recall@10 against exact search on the cut, and the
              @jnp route's ids.
  11. path 3  the LM serving path: TinyLlama-1.1B's CONFIG at full width
              and depth (22 layers), bf16, random weights from
              lm_init_params(cfg, seed=0) on the card, attn_impl="flash".
              Prefill 4 x 4096 tokens into a 4160-slot cache, then 64
              greedy lm_decode_steps; K5's count is zeroed just before and
              read just after (22 launches in the prefill, none in the
              decode, whose attention is chunked). The same prefill on
              attn_impl="chunked", decoding the flash route's tokens: the
              last-position logits and the greedy tokens must agree within
              LM_LOGIT_ATOL and LM_AGREE_FLOOR. lm_embed on the batch must
              be finite, (4, 2048).
  12. K5 main K5 against its plain version on path 3's own layer-0 q, k,
              v, at bf16 and upcast to f32.
  13. timings K5 (bf16: the tensor-core route, every launch of the main
              run counted on it), its plain version, scaled_dot_product_attention (the
              library yardstick; the port never calls it) and the bound at
              path 3's shape; prefill ms, tokens/s and share of the bf16
              peak; decode ms a step (p50) and tokens/s; peak memory.
  14. trace   the card's busy share over one prefill and over 10 decode
              steps (torch.profiler).
  15. K5 Function  flash_attention's gradients against the all-plain route
              (chunked forward and backward) at TinyLlama's heads, B 2,
              S 1024, bf16.
  16. path 4  the LM training path: TinyLlama-1.1B's CONFIG at full width
              and depth, bf16, random weights from lm_init_params(cfg,
              seed=0), attn_impl="flash", on lm_token_batches(0, 4, 4096,
              32000). Step 0's loss and gradient against the reference
              route (attn_impl="chunked", the plain materialized-logits
              CE): |dloss| within TRAIN_LOSS_ATOL, the relative L2 of the
              gradients of lm_head, runs[0]['wq'] and embed within
              TRAIN_GRAD_REL. Then 4 steps of make_train_step(lm_train_
              forward, AdamW(lr 1e-3, warmup 5)), counts zeroed just
              before: each step must launch K5 44 times (forward and remat
              recompute of 22 layers) and K6 4 times (S / seq_chunk), every
              K6 launch on its bf16 tensor-core route; loss
              and parameters finite. Step time (p50 of steps 1-3),
              tokens/s, share of the bf16 peak, peak memory.
  17. trace   one more training step under torch.profiler.
  18. K6 main K6 against its plain version on path 4's own first sequence
              chunk (T 4096, D 2048, V 32000) at bf16 and upcast to f32;
              its time on both routes beside its plain version's, its
              bound and the cross_entropy((h @ w).float()) yardstick (two
              calls; the port never calls it).
  19. drill   run_with_restarts at TinyLlama's SMOKE size on the card: 8
              steps, a checkpoint every 2, a failure injected at step 5;
              the final parameters must match an uninterrupted run within
              DRILL_ATOL.
  20. path 5  the paper's evaluation path, run after phase 10 (before
              path 3 frees the search tensors) on path 1's corpus: 4096
              test queries clustered_corpus(4096, 384, SEED + 2), a
              2048-row fit sample, m = 38 (ratio 0.1 of TARGET_RATIOS).
              The MPAD fit (MPADConfig(m=38, b=80, alpha=25, iters=48))
              and the six BASELINE_FITTERS, each fit and each transform of
              the 1M rows timed; UMAP fitted again from the same draws (F2:
              its map of the queries bit for bit); then amk_accuracy(reducer, corpus,
              queries, k) for every k of K_VALUES, counts zeroed just
              before and read just after (K3 at least twice a call: the
              truth and the reduced space; the Isomap and UMAP transforms
              add theirs). Prints the Fig. 1 row. mpad's and pca's A_m(10)
              against the same reduced vectors through K3's plain
              version, within AMK_TOL.
  21. K3 main K3 against its plain version on the path's own inputs: the
              truth (Q 4096, N 1M, D 384, k 15), the reduced space (D 38),
              the Isomap transform's neighbours (Q 1M, N 2048, k 10).
  22. engines pca64>rr64 (the flat kind, its scan K3 over 1M x 64, ids
              equal to the plain scan route's) and
              mlp64>ivf1024x16>pq16x256:i8@kernel>rr64 (the mlp reducer on
              the ivfpq path, K1; its entry by batch, and the @jnp
              route's ids), each searched at 1, 8, 64 and 256
              queries: p50, QPS, recall@10 against K3's exact truth. F1:
              pca64>rr1024 at batch 64 (K3 at k 1024), ids against the
              plain scan route's, and K3 on that scan's inputs.
  23. exact   the exact fit backend's phi and gradient beside the fast
              backend's on the fit sample at one w (value rtol 1e-5,
              gradient atol 5e-3, tests/test_objective.py's tolerance);
              a short exact fit (m 4, 5 iterations) must be finite.
  24. timings K3, its plain version and its bound at the path's four
              shapes, and the two-call topk(cdist) yardstick at the flat
              engine's (Q 256).

  25. path 6  the streaming engine, run after path 5 (before path 3 frees
              the search tensors): path 1's engine made streaming with
              StreamConfig(delta_capacity=1024) (cell slack 1024, row
              capacity N + 4096, auto-compaction at 768: the defaults),
              then 256 write batches of 64 new ids near existing rows and
              8 overwritten base ids (2,048 in all), each batch deleting
              8 of the previous batch's new ids, 64 queries searched every
              8 batches (K1's counts zeroed just before the write leg and
              read just after: the cell-major entry on the cells' fills
              with a cell-major live byte map (0 on a dead row's posting
              slot, made once a search), never the gathered entry).
              Checks: (a) fresh, the read-only engine's ids at batches 1,
              8, 64 and 256;
              (b) mid-stream (delta not empty, tombstones present) the
              @jnp route's ids at every batch, and K1's masked scan
              bit-equal to its plain version at int8 on the path's own
              inputs; (c) a deleted id never comes back, and an upserted
              row queried returns its own id at distance 0; (d) after the
              final compact the ids of an engine over rebuild_state(frozen,
              survivors), as external ids; (e) recall@10 against exact
              search over the survivors (K3) >= 0.5; (f) begin_compact
              with searches in flight gives, after finish_compact, the ids
              of the blocking fold of a copy; (g) vacuum leaves the
              survivors' ids unchanged. Prints the upsert and delete
              rates, seconds a compaction, the grow count, p50 and QPS at
              every batch beside the read-only engine's, K1's device time
              at batch 256 on the live route against the cand route (dead
              ids -1) and the fills alone on the same store, and the
              card's busy share.
  26. ivf     qpad64>ivf1024x16>rr64 on path 1's corpus (build_engine):
              p50, QPS and recall@10 at every batch; no kernel launches.
  27. pre-filter  ivf1024x16>pq16x256:i8@kernel>rr64 on the first 200,000
              rows with prefilter_batch=64 and 0 over one state: ids equal
              at batches 1, 8 and 64, both p50s, and how often the narrow
              (tight) re-rank ran; then ivf1024x16>pq96x256>rr256 (f32
              LUT, finer codes) the same way, which must take the tight
              branch.
  28. path 7  snapshots and durability on path 1's state, run after the
              pre-filter (before path 3 frees the search tensors), writing
              under chiprun_out/path7_snapshots (fails if fewer than three
              snapshots' worth of bytes are free there; deleted at the
              end). (a) path 1's read-only engine saved and load_engine'd:
              ids and distances equal at every batch, K1's cell-major entry
              launched by the restored engine, save / load s and GB/s, p50
              at 256 beside the original's. (b) the engine made streaming
              (delta 1024) and durable (fsync batch; the initial full
              snapshot timed) beside an oracle that is not durable, the
              same writes on both: 64 batches of path 6's mix (several
              compactions), vacuum (an RT_POLICY record), a full save, 4
              batches, an incremental save, 24 batches, then a batch whose
              delete is logged and crashes (crash_hook at wal_appended);
              the oracle applies the logged record. load_engine recovers:
              every store tensor bit-equal to the oracle's, ids equal at
              every batch, no deleted id, K1's live route launched,
              recall@10 over the survivors (K3) >= 0.5; load s, replay s,
              records, rows, records/s, the time to recover beside path
              1's build. (c) seed_follower from a copy of the full
              snapshot, catch_up(LocalDirSource): store bit-equal to the
              recovered primary's, ids equal; 8 more primary batches, a
              second catch_up to lag 0; a local write on the follower
              raises ReplicationError. (d) durable upsert rows/s under
              fsync never, batch and always on a 20,000-row cut of the
              state, and 4 threads appending 72 x 384 RT_UPSERT records
              under fsync always with group commit (records/s, fsyncs a
              record): host and disk numbers, with the filesystem.

  29. path 8  observability on path 1's engine, run after path 7 (before
              path 3 frees the search tensors); launch counts zeroed just
              before. (a) a traced engine (tracing(histograms, deep trace
              and shadow recall 1-in-4, slow_query_ms 0, a trace_dir))
              and an untraced one over path 1's state: ids and distances
              bit-equal at batches 1, 8, 64 and 256 (4 searches each),
              compile_count equal after every search; K1's cell-major
              entry counted for the searches and the deep traces' warm
              and timed passes. (b) deep_trace at batches 1 and 256 (5
              each): JAX's stage names, the stages summing within 10% of
              the staged e2e, K1's cell-major entry once a trace; the
              stage ms (p50). (c) each shadow sample's recall equals
              recall_at_k against the phase's own K3 truth over the 1M
              rows; K3 launches equal the samples. (d) path 1's engine
              made streaming (delta 1024), 24 write batches of path 6's
              mix (two compactions), one search shadow-checked:
              metrics() has its stream, compact and policy sections,
              stream.tombstones the store's dead count, compact.compactions
              the engine's count, the shadow recall that over the
              survivors (K3). (e) a MetricsServer on port 0 scraped from
              this thread while another runs 200 traced searches at batch
              64: every scrape parses (one TYPE line a family, histograms
              cumulative, qpad_engine_info last). (f) flush_trace's
              Chrome trace loads (one search event a traced search);
              torch_profile's trace of 5 searches holds K1 kernel
              records. (g) p50 overhead of histograms-only tracing and of
              an attached but inactive tracer at batches 1 and 256, 20
              alternating rounds of 10 searches (host clock,
              synchronized); reported, not gated.

  30. path 9  sharded serving on the one card, run after path 8 (before
              path 3 frees the search tensors). (a) a world of 1 over
              NCCL in this process: path 1's ivfpq engine, path 2's pq
              engine and a flat pca64>rr64 engine sharded
              (SearchEngine.shard), ids equal to the unsharded engine's
              at batches 1, 8, 64 and 256, distances within 1e-5; p50s
              sharded and unsharded; launches on the sharded route, K1's
              cell-major entry alone (ivfpq), K2 through
              pq_adc_topk_global (pq), K3 (flat): launches_path9 in the
              kernels line. Then K2's global entry over 3 row blocks of
              path 2's 1,000,000 codes (2 pad rows, slack 2, k 64, int8,
              batch 256) against pq_adc_topk_global_plain: d2 and ids
              bit-equal, the blocks merged in rank order equal to the
              unsharded K2's ids. (b) worlds of 3 and 2 gloo ranks on
              cuda:0 (launch.mesh.run_ranks; 1,000,000 % 3 and 1024 % 3
              leave pad rows and pad cells live): each rank restores
              path 1's snapshot onto the mesh (load_engine(dir,
              mesh=...)), and world 3 path 2's pq snapshot too (K2's
              global entry with pad rows live); rank 0's ids equal the
              unsharded engine's at every batch, every rank's the same;
              then a streaming engine restored, sharded, through 8
              batches of path 6's write mix, ids after each equal to an
              unsharded streaming engine's that took the same writes;
              world 3's p50s (host-staged collectives on one card, not a
              deployment's). (c) fit_mpad_sharded on path 1's 2048-row
              fit sample at world 1 (NCCL) and 2 (gloo, in the world-2
              ranks) against fit_mpad on the fast backend at JAX's
              test's m 3 / iters 16: matrix max |d| < 0.05; at path 2's
              m 64, make_phi_dist's first three steps at world 1 and 2
              against phi_fast_value_and_grad on the whole sample (value
              rtol 1e-5, gradient rtol 1e-3 / atol 1e-5). The m-64 fits
              and their spread under a reordering of the rows are
              --fit-spread's, below. A failing rank fails the run.

  31. path 10  the MoE LMs served on K5, after path 4 (whose tensors are
              freed first): granite-moe-1b-a400m's and olmoe-1b-7b's
              CONFIGs in turn at full width and depth, bf16, random
              weights from lm_init_params(cfg, seed=0), attn_impl="flash".
              Prefill 4 x 4096 on the configured MoE impl (ep with no mesh:
              dispatch), then 64 greedy decode steps on the dense
              combine (configs.shape_config(cfg, "decode")), then
              lm_embed; K5's counts zeroed just before and read just after
              each main run. (a) K5 n_layers times in the prefill, none in
              the decode, all on mma_bf16; K5 against its plain version on
              the path's own layer-0 q, k, v (k5_tolerance). (b) On the
              path's own layer-0 MoE input (16,384 tokens): dispatch at
              capacity_factor E / K (nothing dropped) against dense, the
              expert ids equal and each token row within MOE_ROW_REL; at
              capacity_factor 1.25 the dropped assignments equal a count
              over the expert ids made on the host. (c) Two prefills give
              bit-equal logits. (d) The chunked route, teacher-forced:
              greedy agreement >= LM_AGREE_FLOOR; the logits' max |diff|
              and the layer-0 expert sets that differ are reported. (e)
              Logits finite, (4, vocab_padded). Reported: init s, prefill
              ms, tokens/s and share of the bf16 peak (active parameters
              plus attention), decode ms a step, peak memory, K5's time at
              the shape beside its bound, plain version and SDPA, the MoE
              block's times (router, dispatch tables, expert matmuls,
              dense at the decode batch) and share of the prefill, and the
              card's busy share over a prefill and 10 decode steps.
  32. path 11  the recsys family at the published configs (f32, random
              weights from seed 0), serve_p99's batch 512 and
              retrieval_cand's 2^20 candidates: sasrec_serve_topk (k 100)
              whose ids above the k-th score equal a one-shot topk over
              the (512, 2^20) scores; dien_forward at 512 and dien_score
              over 2^20 candidates, 256 of them against dien_forward
              (RECSYS_RTOL / RECSYS_ATOL); autoint_forward at 512 and
              autoint_score_candidates over 2^20, 256 against the
              unchunked forward; the two-tower item tower over 2^20 items
              (the 1 GB candidate cache), fit_mpad at m 64 on a 2048-row
              sample on K4 (counts zeroed just before the fit, read just
              after: 3,072 launches), quantize_candidates (codes and
              scales bit-equal to the host's), twotower_retrieve in full,
              mpad and int8 modes (k 100, re-rank 256): full's ids above
              the k-th score equal an f64 scan's, every returned score
              the id's exact u . cand within its f32 rounding bound;
              overlap@100 with full (reported only); the pairwise
              serve_p99 scoring at 512. p50 ms by CUDA events and items
              scored a second for every serve step.

  33. path 12  gin-tu (configs.gin_tu: 5 layers, d_hidden 64) trained at
              the four GNN_SHAPES (configs.gnn_family), f32, random weights
              from seed 0, GNN_STEPS AdamW steps each; the graphs from
              make_random_graph (made on the host in a thread beside the
              build and the edge cases, before any timed path), full-graph
              edge lists padded with masked
              edges to a multiple of 512. full_graph_sm (N 2,708, E
              10,752, F 1,433) and ogb_products (N 2,449,029, E
              61,859,328, F 100, full size) on the aggregate (build_csr
              once a graph; 5 forward and 4 backward launches a step,
              checked each step); minibatch_lg (1,024 seeds, fanout (15,
              10), F 602, sampled from a Reddit-sized graph: 232,965
              nodes, 11,606,919 edges); molecule (128 graphs of 30 nodes,
              F 32). Checks: step 0's loss within GNN_RTOL of the port's
              CPU route and every gradient leaf within GNN_RTOL of the CPU
              route run with the card's ReLU decisions, each ReLU input of
              another sign within GNN_FLIP_REL of its call's largest
              (full_graph_sm, minibatch_lg, molecule); on full_graph_sm
              every aggregate of step 0 (5 forward, 4 backward) bit-equal
              to the plain version on the host copy, and a second run of
              the steps bit for bit; on ogb_products layer 0's and 1's
              aggregate on GNN_ROW_SAMPLE rows bit-equal to the host's
              index_add over those rows' edges, layer 0's output there
              within GNN_RTOL of the CPU route, and the source order (the
              backward's) on GNN_ROW_SAMPLE source rows, node 0 (the
              longest, ~19,800 edges) among them, bit-equal to the host's
              index_add on the gradient agg_timing times; losses finite.
              Reported:
              step ms (p50 of steps 1-2), nodes / seeds / graphs a second,
              gin_flops over the time, peak memory; the aggregate at
              ogb_products forward F 100 and 64, backward 64, beside its
              bounds, its plain version, torch.sparse.mm (the library
              yardstick) and index_add_ on materialised messages.
  34. path 13  training on the card at full width: granite-moe-1b-a400m
              as path 4 trains TinyLlama (4 x 4096, bf16, remat, 4 steps;
              step 0 flash + K6 against chunked + the plain CE within
              TRAIN_LOSS_ATOL and TRAIN_GRAD_REL on embed, runs[0].wq and
              its MoE w_down and router; K5 2 x n_layers and K6 4
              launches a step, all on the bf16 routes), with K5 (and its
              Function's backward a layer) and K6 over the tied head at
              its shapes; then SASRec, DIEN, AutoInt and the two-tower
              model at the published configs and train_batch (65,536), 3
              steps each, step 0 on a RECSYS_CHECK_ROWS slice against the
              port's CPU route (RECSYS_LOSS_RTOL, RECSYS_GRAD_REL). Step
              ms, tokens or examples a second, peak memory.
  35. path 14  granite-moe-1b-a400m trained over a ("data", "model") mesh
              of ranks (repro_torch.parallel.step: expert parallelism
              over "model" on the MoE layers, every other parameter
              gathered at use, the gradients' mean over "data", ZeRO-1
              moments). (a), between path 13's two halves: one rank over
              NCCL, a (1, 1) mesh, at path 13's shapes (full width and
              depth, 4 x 4096, bf16, impl "ep"): 2 steps, counts zeroed
              just before, K5 48 and K6 4 launches a step on their bf16
              routes; the losses and every parameter against path 13's
              first 2 steps (lm_train_run) on the same parameters and
              batches, bit for bit. (b), after path 13: 4 gloo ranks on
              cuda:0, a (2, 2) mesh, at full width cut to 6 layers and
              4 x 1024 tokens (gloo stages every collective through host
              memory): at capacity_factor E / K = 4.0 (nothing dropped),
              step 0's gradient and 2 steps against the same in one
              process (|dloss| within TRAIN_LOSS_ATOL, each leaf's step-0
              gradient rel L2 within TRAIN_GRAD_REL; each leaf's update
              rel L2 reported); each rank's K5 12 and K6 1
              launches a step on the bf16 routes; a third step's ZeRO-1
              update bit-equal, on every rank, to the one-process
              adamw_update of the rank's parameter blocks from the same
              parameters, moments and gradient blocks and the step's
              norm (zero_check_step); at the config's 1.25,
              layer 0's EP block on the one-process layer-0 input against
              dispatch on each model slice at the slice's capacity: the
              expert ids equal, rows within MOE_ROW_REL, the dropped
              assignments the host's count, aux within SHARD_AUX_RTOL.
              Step ms ((b): gloo on one card, not a deployment's number),
              per-rank peak memory, the bytes each rank puts into each
              collective kind a step.
  36. path 15  the dry-run tools (repro_torch.launch.dryrun and
              dryrun_mpad), each cell in a subprocess of its own, all at
              once, through their command lines (fake worlds on fake
              CUDA tensors: no card). (a) One cell a family on both
              production meshes (olmoe-1b-7b train_4k, two-tower
              retrieval_cand, gin-tu ogb_products): status, argument
              bytes a rank,
              predicted peak, FLOPs against model_flops, collective bytes
              by kind. (b) Against this run's path 14: at (a)'s cut ((1,
              1), 4 x 4096) the argument bytes equal the rank's real
              parameters, moments and int32 batch exactly, K5 48 and K6 4
              launches a step, the predicted peak within DRY_PEAK_RTOL of
              (a)'s max_memory_allocated; at (b)'s cut ((2, 2), 6 layers,
              4 x 1024, cf 4.0) the bytes a rank a step by collective kind
              equal (b)'s measured counts, K5 12 and K6 1, and the trace on
              meta tensors equals the one on fake CUDA tensors. (c) At
              SMOKE size (granite SMOKE, a small full-graph GIN) on a (1,
              1) mesh: a real step on the card and its fake trace read the
              same FLOPs (FlopCounterMode), unfused bytes, argument bytes
              and K5 / K6 / aggregate launches. (d) dryrun_mpad at world 1,
              N 2^20 x 1024: the fake trace against a real iteration on the
              card (NCCL, world 1): FLOPs and collective bytes equal, the
              peak within DRY_PEAK_RTOL. (e) olmoe-1b-7b at 4 x 4096 on a
              (4, 1) ZeRO-1 and a (1, 4) EP mesh: the predicted peak a rank
              against the card's 80 GB, reported. (a) also holds gemma3-4b
              long_500k on both meshes (status ok), and one job traces
              path 16's cuts (``--dryrun-serve``) for path 16 (d). Path
              16 (b)'s gloo ranks run while the jobs finish (both host
              work; the traces leave cores idle once the short ones end).
  37. path 16  LM prefill and decode over a ("data", "model") mesh
              (parallel.step's serving rank programs: the KV cache split
              on the sequence under lm_cache_specs, decode attention
              merged across the ranks). (a) TinyLlama-1.1B at full width
              and depth on a (1, 1) NCCL mesh at one (16, 16) production
              rank's share of each cell: prefill_32k's 2 x 32,768 (K5 22
              launches, bf16) and decode_32k's 8 rows over a 32,768-slot
              cache filled by a prefill of 32,752 tokens, then 16 decode
              steps; logits and every cache leaf bit-equal to the
              unsharded lm_prefill / lm_decode_step; prefill ms and tok/s,
              decode ms a step (p50) and busy share, peak memory; K5 at
              (B 2, S 32,768) beside its plain version, SDPA and its
              bound. (b) gloo ranks on cuda:0 at full width and cut depth
              (SERVE_B_CASES: TinyLlama on (1, 4), the sequence split over
              "model"; granite-moe-1b-a400m on (2, 2), EP prefill and
              dense decode; gemma3-4b 5 local + 1 global layers on (2, 2),
              batch 1, the global cache over every axis, the windows
              whole): a prefill, then decode steps fed one process's
              greedy tokens; the cache blocks bit-equal to one process's
              slices (granite: within SERVE_B_MOE_REL where EP's expert
              matmuls round otherwise); the decode logits within
              SERVE_B_LOGIT_ATOL * sqrt(layers / 22) of one process's
              lm_decode_step from the ranks' own prefill cache, greedy
              agreement >= LM_AGREE_FLOOR; the bytes a rank puts into each
              collective kind. (c) gemma3-4b
              long_500k at full size on a (1, 1) NCCL mesh: 34 layers,
              batch 1, 524,288 slots seeded with K / V, 8 decode steps
              bit-equal to lm_decode_step; ms a step beside its read bound
              (the cache and the parameters at the HBM rate). (d) path
              15's traces of (a)'s and (b)'s cuts: argument bytes equal
              (a)'s real blocks, K5 22 in (a)'s prefill, the collective
              bytes by kind equal (b)'s counts, the predicted peak within
              DRY_PEAK_RTOL of (a)'s max_memory_allocated.

Before those, one line {"result": {...}} holds every measurement of the
run (``result.path4`` for the training path, ``result.path5`` for the
evaluation path, ``result.path6``, ``result.ivf``,
``result.prefilter``, ``result.path7``, ``result.path8``,
``result.path9``, ``result.path10``, ``result.path11``,
``result.path12``, ``result.path13``, ``result.path14``,
``result.path15`` and ``result.path16``, and ``result.wall_s``). The line
before the last is {"kernels": [...]} (K1, K2, K4, K5, K6, K3 and the
GIN aggregate); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = "qpad64>ivf1024x16>pq16x256:i8@kernel>rr64"
SPEC_PQ = "qpad64>pq16x256:i8@kernel>rr64"
SPEC_OPQ = "qpad64>opq16x256:i8@kernel>rr64"
FIT = dict(m=64, b=80.0, alpha=25.0, iters=48, seed=0)   # path 2's QPAD fit
FIT_SAMPLE = 2048                # rows the engine fits on (its default)
FIT_CHECK_M = 8                  # directions of the fused-vs-two-step fit check
N, DIM, SEED = 1_000_000, 384, 0
BATCHES = (1, 8, 64, 256)
K = 10
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM non-tensor f32 peak (data sheet)
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor peak (data sheet)
LUTS = ("f32", "bf16", "int8")
RECALL_FLOOR = 0.5               # a broken scan or re-rank lands far below
RERANK = 64                      # candidates the pq / opq scans return
# path 5: the paper's evaluation path (A_m(k) of MPAD and the six
# baselines at ratio 0.1) over the 1M corpus, with test queries from its
# distribution, and two engines on the port's new reducers
EVAL_Q = 4096
SPEC_FLAT = "pca64>rr64"
SPEC_MLP = "mlp64>ivf1024x16>pq16x256:i8@kernel>rr64"
# F1: a flat engine whose re-rank budget needs K3 at k = 1024
SPEC_FLAT_WIDE, WIDE_RERANK, WIDE_BATCH = "pca64>rr1024", 1024, 64
# F3: int32 codes (K 1024) through K2, on a cut of the corpus
SPEC_PQ1024, PQ1024_ROWS = "pq8x1024:i8@kernel>rr64", 200_000
# path 6: path 1's engine made streaming (delta 1024; cell slack 1024,
# row capacity N + 4096 and auto-compaction at 768 are StreamConfig's
# defaults), then the launcher's write leg scaled up: 256 write batches of
# 64 new ids near existing rows and 8 overwritten base ids (2,048 in all),
# each batch deleting 8 of the previous batch's new ids, 64 queries
# searched after every 8 batches
STREAM_DELTA, STREAM_BATCHES, STREAM_NEW, STREAM_OVERWRITE = 1024, 256, 64, 8
STREAM_DELETE, STREAM_SEARCH_EVERY, STREAM_Q = 8, 8, 64
STREAM_NOISE = 0.01              # offset of a written row from its source
STREAM_AT = (1, 8, 64, 256)      # write batches after which ids are checked
# path 7: snapshots and durability on path 1's state. A durable streaming
# engine (delta 1024, fsync batch) beside an oracle that is not durable:
# PERSIST_BATCHES write batches of path 6's mix (several compactions),
# vacuum, a full save, PERSIST_INC_BATCHES more (no compaction), an
# incremental save, PERSIST_TAIL_BATCHES more and one crashed batch;
# then a follower, and PERSIST_FOLLOW_BATCHES more on the primary
PERSIST_BATCHES, PERSIST_INC_BATCHES = 64, 4
PERSIST_TAIL_BATCHES, PERSIST_FOLLOW_BATCHES = 24, 8
# (d): durable upsert rates by fsync mode on a cut of path 1's state;
# group commit under concurrent appenders
PERSIST_RATE_ROWS, PERSIST_RATE_BATCHES = 20_000, 16
PERSIST_THREADS, PERSIST_RECORDS, PERSIST_GROUP_MS = 4, 64, 2.0
# the ivf kind on path 1's corpus; the pre-filter on a cut of it (no
# Reduce stage: the scan space must be the re-rank space)
SPEC_IVF = "qpad64>ivf1024x16>rr64"
# path 9 (sharded serving): gloo worlds on the one card, write batches of
# path 6's mix checked after each, timing repeats
SHARD_GLOO_WORLDS = (2, 3)
SHARD_WRITE_BATCHES = 8
SHARD_REPS = 10
# (c)'s fit: JAX's own test's configuration (m 3, iters 16:
# tests/test_distributed.py), where its 0.05 is well-posed
SHARD_FIT_JAX_TEST = dict(m=3, b=80.0, alpha=25.0, iters=16, seed=0)
SPREAD_PERMS = 4        # --fit-spread: permutations of the fit sample
SPEC_PREFILTER, PREFILTER_ROWS = "ivf1024x16>pq16x256:i8@kernel>rr64", 200_000
# the pre-filter's narrow branch: an f32 LUT (no LUT bound) over finer
# codes (4-dim subspaces, a smaller reconstruction error) with a wider
# re-rank, so that the queries' certified survivors fit r_s = 128
SPEC_PREFILTER_TIGHT = "ivf1024x16>pq96x256>rr256"
# A_m(10) through K3 against its plain version on the same reduced
# vectors: the two compute d2 with sums in other orders (~1e-6 apart), so a
# neighbour at a near-tie with the 10th may flip; 1e-3 is 41 of the 40,960
# (query, neighbour) slots
AMK_TOL = 1e-3
# path 3: TinyLlama-1.1B serving, prefill B x S (train_4k's sequence;
# prefill_32k's batch 32 and sequence 32768 are cut to fit the time limit),
# then greedy decode steps into a cache of LM_MAX_LEN slots
LM_BATCH, LM_SEQ, LM_MAX_LEN, LM_DECODE = 4, 4096, 4160, 64
# flash and chunked prefill differ only in f32 summation order inside the
# attention, rounded to bf16 once, and carried through 22 layers: their
# last-position logits (std ~1 at random weights) may differ by a few bf16
# ulps of the hidden state, and greedy tokens may flip only on near-ties
LM_LOGIT_ATOL = 0.25
LM_AGREE_FLOOR = 0.75
# K6 against its plain version: the same f32 products (a bf16 product is
# exact in f32) summed in another order; losses are ~ln V ~ 10
K6_TOL = dict(atol=1e-4, rtol=1e-5)
# K5's Function against the all-plain route: the same chunked backward on
# the same cotangent, so the gradients agree to f32 rounding
K5_GRAD_RTOL = 1e-5
# path 4: TinyLlama-1.1B training at train_4k's sequence 4096, its batch
# 256 cut to 4 (one card's memory and the run's time), 4 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 4
# flash + K6 against chunked + the plain CE on step 0: both routes in bf16,
# differing in the f32 summation order inside attention (rounded to bf16
# once a layer, through 22 layers and back) and inside the CE; at SMOKE
# size the port and JAX, which round bf16 at more places, differ by 1.4e-3
# in the loss and 1.5-3% in gradient L2
TRAIN_LOSS_ATOL = 0.01
TRAIN_GRAD_REL = 0.05
# the restart drill at TinyLlama's SMOKE size (f32): not bit for bit on the
# card, since the embedding gather's backward accumulates with atomics, in
# an order that changes from run to run; a ulp of a gradient moves an
# AdamW update by far less than lr = 1e-3
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 8, 2, 5
DRILL_ATOL = 1e-4
# path 10: the MoE LMs (granite-moe-1b-a400m, olmoe-1b-7b) served as path
# 3 serves TinyLlama (LM_BATCH x LM_SEQ prefill on the configured MoE
# implementation, ep with no mesh: dispatch; LM_DECODE greedy steps on the
# dense combine, as lm_family.shape_config gives decode). dispatch with
# capacity_factor E / K (no assignment can be dropped) against dense on
# the path's own layer-0 MoE input, bf16: the same router (the expert ids
# equal) and the same expert matmuls (f32 sums rounded to bf16, maybe in
# another order at another M); dispatch rounds each of a token's K gated
# contributions to bf16 and adds them one after another in bf16, dense
# sums them in f32 and rounds once. Each rounding is 2^-9 of one
# contribution; K contributions of about one size in random directions sum
# to about sqrt(K) of one, so K + 1 independent roundings come to about
# 2^-9 of the row, and a bf16 ulp of every expert output (another matmul
# order) to 2^-8. A token row's ||dispatch - dense|| / ||dense|| within
# 2^-5 leaves 8x over that
MOE_ROW_REL = 2.0 ** -5
# path 11: the recsys family at the published configs (f32, random weights
# from seed 0): serve_p99's batch and retrieval_cand's 2^20 candidates
# (configs.recsys_family.RECSYS_SHAPES), k 100 (its _TOPK); DIEN's and
# AutoInt's candidate scoring checked against the forward on
# RECSYS_SAMPLE candidates at JAX's tests' tolerance (the same f32
# operations in matmuls of other shapes); the two-tower reducer fitted on
# a FIT_SAMPLE-row sample of the candidate cache with path 2's fit
# settings at m = MPAD_DIM on K4; DIEN's AUGRU over RECSYS_DIEN_CHUNK
# candidates a batch; the item tower RECSYS_TOWER_CHUNK items a call
RECSYS_SAMPLE = 256
RECSYS_RTOL, RECSYS_ATOL = 1e-4, 1e-5
RECSYS_REPS = 5
RECSYS_DIEN_CHUNK = 1 << 16
RECSYS_TOWER_CHUNK = 1 << 18
# path 12: gin-tu (configs.gin_tu: 5 layers, d_hidden 64) trained at the
# four GNN_SHAPES of configs.gnn_family, f32, GNN_STEPS AdamW steps each
# (gnn_family's AdamW), the graphs from data.make_random_graph at
# GNN_SEED + i, each full-graph edge list padded to a multiple of 512
# with masked (0 -> 0) edges. minibatch_lg samples its batch from a graph
# of Reddit's size (GraphSAGE's dataset, whose width 602 and 41 classes
# the shape carries). ogb_products runs at full size (features 0.98 GB,
# both CSR orders ~1.5 GB); its CPU route cannot run (the full-graph loss
# materialises 24.7 GB of messages a layer on the host), so it is held
# against the host on GNN_ROW_SAMPLE rows instead
GNN_STEPS = 3
GNN_SEED = SEED + 20
REDDIT_NODES, REDDIT_EDGES = 232_965, 11_606_919
GNN_ROW_SAMPLE = 4096
GNN_LABEL_SHARE = 0.5            # nodes with a training label (label_mask)
GNN_MOL_EDGE_P = 0.1             # molecule adjacency: symmetric 0/1, no loops
# step 0 on the card against the port's CPU route: the aggregate is
# bit-equal, the MLP matmuls (cuBLAS against the host's BLAS) and the
# reductions sum in other orders; each gradient leaf within GNN_RTOL of
# an entry plus GNN_RTOL of the leaf's largest (entries near 0 are sums
# of terms of that size)
GNN_RTOL = 1e-4
# a ReLU input within rounding of 0 may take another sign on the card than
# on the host: each such input within GNN_FLIP_REL of its call's largest
# (f32 rounds at 6e-8 relative; a matmul's sum of 64 to 1,433 products
# differs by up to ~1e-6 between two orders)
GNN_FLIP_REL = 1e-5
# path 13: granite-moe-1b-a400m trained as path 4 trains TinyLlama
# (TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps, bf16, remat as configured,
# the same bounds on step 0), then the recsys family at train_batch
# (65,536: DIEN's 100 GRU steps peak at 62.3 GB, so no model is cut),
# RECSYS_TRAIN_STEPS steps each, step 0 held against the port's
# CPU route on a RECSYS_CHECK_ROWS slice of the same batch at
# tests/test_torch_recsys.py's tolerances (loss rtol 1e-5, each gradient
# leaf's relative L2 1e-5 unless its norm is <= 1e-7): the same f32
# operations, matmuls and scatter-adds in other orders
RECSYS_TRAIN_STEPS = 3
RECSYS_CHECK_ROWS = 512
RECSYS_LOSS_RTOL, RECSYS_GRAD_REL = 1e-5, 1e-5
# path 14: granite-moe-1b-a400m trained over a ("data", "model") mesh of
# ranks (parallel.step: EP over "model" on the MoE layers, every other
# parameter gathered at use, ZeRO-1 moments). (a) one rank over NCCL, a
# (1, 1) mesh, at path 13's shapes (full width and depth): its first
# SHARD_TRAIN_STEPS steps against path 13's on the same parameters and
# batches. (b) SHARD_MESH gloo ranks on the one card: gloo stages every
# collective through host memory, so (b) is cut to SHARD_B_LAYERS layers
# and SHARD_B_BATCH x SHARD_B_SEQ tokens (full width: d 1024, 16 / 8
# heads, 32 experts of d_ff 512, top-8, vocab 49,408); two steps at
# capacity_factor E / K (no assignment dropped anywhere, so EP's output is
# dispatch's and only the aux loss's slices differ) against the same
# steps in one process: |dloss| within TRAIN_LOSS_ATOL and step 0's
# gradient within TRAIN_GRAD_REL (path 4's bf16 bounds). The parameters'
# updates after the two steps are reported, not held to 0.05: Adam's first
# steps move an element by about lr * sign(g), so the elements whose
# gradient is within the two routes' rounding of 0 move the other way,
# and bf16 parameters round an update of about an ulp either way:
# gradients 0.2-2.7% apart gave updates 1-13% apart on an H100 80GB HBM3
# at 700 W (PERF.md, path 14). The update's mechanism is held apart from
# that: a third step's ZeRO-1 update against the one-process adamw_update
# on each rank's blocks, bit for bit (zero_check_step). At the config's
# 1.25 layer 0's EP block against dispatch on each model slice at that
# slice's capacity (the expert ids equal, rows within MOE_ROW_REL, the
# dropped assignments the host's count, aux within SHARD_AUX_RTOL)
SHARD_TRAIN_STEPS = 2
SHARD_MESH = (2, 2)
SHARD_B_LAYERS, SHARD_B_BATCH, SHARD_B_SEQ = 6, 4, 1024
SHARD_AUX_RTOL = 1e-5
# path 15: the dry-run (repro_torch.launch.dryrun) in subprocesses, all at
# once (one process a cell; its traces need no card), held against this
# run's own path 14 and against real steps. DRY_PEAK_RTOL: a predicted
# peak (live storage over a traced step, 512-byte blocks) against the
# card's max_memory_allocated, written in PERF.md before the first card
# run: the trace does not see cuBLAS's workspace or the kernels' scratch,
# and the real run holds what was allocated before the step
DRY_PEAK_RTOL = 0.05
DRY_TIMEOUT_S = 600
DRY_CELLS = (                    # (a): one cell a family, both meshes
    ("olmoe-1b-7b", "train_4k", "single"),     # (the LM cells trace longest:
    ("olmoe-1b-7b", "train_4k", "multi"),      # one job a mesh)
    ("two-tower-retrieval", "retrieval_cand", "both"),
    ("gin-tu", "ogb_products", "both"),
    ("gemma3-4b", "long_500k", "both"))
DRY_FOUR_CARDS = ("4x1", "1x4")  # (e): olmoe-1b-7b at 4 x 4096 on 4 ranks
DRY_SMOKE_BATCH, DRY_SMOKE_SEQ = 2, 32
CARD_BYTES = 80e9
# path 16: LM serving over a ("data", "model") mesh (parallel.step's
# prefill and decode rank programs). (a) TinyLlama-1.1B (full width and
# depth, bf16) on a (1, 1) NCCL mesh at one (16, 16) production rank's
# share of each cell: prefill_32k's 32 rows over 16 data ranks
# (SERVE_PREFILL_BATCH x SERVE_SEQ) and decode_32k's 128 rows
# (SERVE_DECODE_BATCH over SERVE_SEQ slots, filled by a prefill of
# SERVE_FILL tokens, then SERVE_DECODE steps); one rank runs the unsharded
# operations, so both are bit-equal to lm_prefill / lm_decode_step
SERVE_PREFILL_BATCH, SERVE_SEQ = 2, 32768
SERVE_DECODE_BATCH, SERVE_FILL, SERVE_DECODE = 8, 32752, 16
# (b) gloo ranks on cuda:0 (every collective staged through the host), full
# width, cut depth: (arch, mesh, layers, batch, prompt) into
# SERVE_B_SLOTS-slot caches (lm_cache_specs' threshold: the global runs'
# sequence split), then SERVE_B_STEPS greedy decode steps against one
# process. The prompts leave the last blocks empty during the decode (a
# rank with no visible slot: the merge's trap). granite runs at
# capacity_factor E / K, so no assignment is dropped and EP's prefill is
# one process's dispatch up to the expert matmuls' rounding
SERVE_B_SLOTS, SERVE_B_STEPS = 8192, 4
SERVE_B_CASES = (("tinyllama-1.1b", (1, 4), 4, 2, 3000),
                 ("granite-moe-1b-a400m", (2, 2), 4, 4, 1024),
                 ("gemma3-4b", (2, 2), 6, 1, 3000))
# the decode logits against one process's lm_decode_step from the ranks'
# own prefill cache, so that only the merge differs: it changes only the
# f32 summation order inside decode attention (each rank's sums of its
# block, then the ranks' sums), rounded to bf16 once a layer; path 3's
# LM_LOGIT_ATOL bounds flash against chunked, which differ the same way and
# more (K5 rounds P to bf16 before P·V) through 22 layers. Such errors add
# over the layers about as a random walk, so a cut of L layers is held to
# LM_LOGIT_ATOL * sqrt(L / 22): 0.107 at 4 layers, 0.131 at 6
SERVE_B_LOGIT_ATOL = LM_LOGIT_ATOL
# granite's prefill cache blocks against one process's: EP's expert bmms run
# at other shapes than dispatch's (a slice's tokens, half the experts a
# rank), so their bf16 outputs may round otherwise, and every layer after
# the first reads them; each (layer, block) within MOE_ROW_REL relative L2,
# its bound on one MoE block's rounding. The dense cases are held bit for
# bit (every rank runs one process's operations on the same rows)
SERVE_B_MOE_REL = MOE_ROW_REL
# (c) gemma3-4b long_500k at full size: batch 1, LONG_SLOTS slots seeded
# with K / V up to LONG_SLOTS - LONG_STEPS, then LONG_STEPS decode steps
LONG_SLOTS, LONG_STEPS = 524288, 8


# kernel-name fragments for a trace's device time by group (first match)
_GROUPS_HEAD = (
    ("K5 flash_fwd", ("flash_fwd",)),
    ("K6 ce_partial/ce_merge", ("ce_partial", "ce_merge")),
    ("K1/K2/K4", ("adc_", "pair_")),
    ("K3 knn_select", ("knn_select", "row_sqnorms")),
    ("GEMM f32", ("f32f32_f32f32",)),
    ("GEMM bf16", ("gemm", "xmma", "cutlass", "nvjet")),
)
_ELEMENTWISE = ("elementwise", ("elementwise",))
_REDUCE = ("reduce", ("reduce_kernel",))
_MOVES = ("index/scatter/gather", ("index", "scatter", "gather"))
_COPY = ("copy", ("copy", "cat"))
_MOE = (("softmax (the MoE router)", ("softmax", "SoftMax")),
        ("sort (the MoE top-k and dispatch)", ("sort", "Sort")))
KERNEL_GROUPS = _GROUPS_HEAD + (_ELEMENTWISE, _REDUCE, _MOVES, _COPY) + _MOE
# path 10's: the MoE dispatch's moves (index_elementwise_kernel,
# _scatter_gather_elementwise_kernel) ahead of "elementwise", which takes
# them first in KERNEL_GROUPS (kept in its order so that the older paths'
# groups stay comparable across runs)
MOE_KERNEL_GROUPS = _GROUPS_HEAD + _MOE + (_MOVES, _ELEMENTWISE, _REDUCE,
                                           _COPY)


# each ported kernel's name fragment in a trace, beside the wrappers whose
# ``launches`` count its launches (filled in by main once the port is
# imported): a trace that holds fewer such kernels than the wrappers
# launched in its window lost records (``kernel_trace``)
TRACED_KERNELS = []
# every trace ``kernel_trace`` found lacking records, and whether it was
# used; printed in the result line
TRACE_LOSSES = []
TRACE_ATTEMPTS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def clustered_corpus(n, d, seed, n_clusters=4096, spread=32, local=16):
    """Unit-norm clustered embeddings of low intrinsic dimension, as
    sentence-embedding corpora have: cluster centres in a ``spread``-dim
    subspace, each point offset from its centre in a ``local``-dim
    subspace, plus small isotropic noise. numpy, from ``seed``; the
    subspaces come from ``seed`` alone, so corpus and queries
    (another ``seed`` offset of the same generator family) share them."""
    base_rng = np.random.default_rng(12345)
    b1 = base_rng.standard_normal((spread, d), dtype=np.float32) / np.sqrt(d)
    b2 = base_rng.standard_normal((local, d), dtype=np.float32) / np.sqrt(d)
    centers = base_rng.standard_normal((n_clusters, spread),
                                       dtype=np.float32) @ b1
    rng = np.random.default_rng(seed)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, 200_000):
        e = min(n, s + 200_000)
        lab = rng.integers(0, n_clusters, e - s)
        z = rng.standard_normal((e - s, local), dtype=np.float32)
        x = (centers[lab] + 0.4 * (z @ b2)
             + 0.01 * rng.standard_normal((e - s, d), dtype=np.float32))
        out[s:e] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return out


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_trace(torch, fn, reps, label, warm=True):
    """The kernels of ``reps`` calls of ``fn`` in one torch.profiler trace
    (the device time, count and name of each), and the window's host µs,
    which ends in a synchronize; with ``warm``, one call runs first,
    untraced. On an H100 a trace now and then lacks kernel records (a
    window of 10 searches held 9 of its 10 K1 launches, with or without
    the profiler's warm-up step; once a window held none; late in a long
    run, a window of 200 fused K4 launches held 199, three times in a
    row), so each trace is held against the launches the port's wrappers
    counted in its window (``TRACED_KERNELS``). One that lacks any is
    taken again, up to ``TRACE_ATTEMPTS`` traces; the first complete one
    is returned, else the one that lost the fewest records. Every
    incomplete trace is logged and kept in ``TRACE_LOSSES`` (the result
    line's ``trace_losses``), marked ``used`` where it was returned. A
    window with no device time in every trace fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    best = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = [sum(w.launches for w in ws) for _, ws in TRACED_KERNELS]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        lost = {}
        for (frag, ws), n0 in zip(TRACED_KERNELS, before):
            launched = sum(w.launches for w in ws) - n0
            traced = sum(e.count for e in kern if frag in e.key)
            if traced < launched:
                lost[frag] = {"launched": launched, "traced": traced}
        if busy_us > 0 and not lost:
            return kern, wall_us
        record = {"label": label, "attempt": attempt, "device_us": busy_us,
                  "lost": lost, "used": False}
        TRACE_LOSSES.append(record)
        log(f"[trace] {label}: trace {attempt} of {TRACE_ATTEMPTS} lost "
            f"records (device time {busy_us:.1f} us; kernels launched / "
            f"traced: {lost})")
        missing = sum(v["launched"] - v["traced"] for v in lost.values())
        if busy_us > 0 and (best is None or missing < best[0]):
            best = (missing, kern, wall_us, record)
    check(best is not None, f"{label}: the profiler recorded no device time "
          f"in {TRACE_ATTEMPTS} traces")
    best[3]["used"] = True
    log(f"[trace] {label}: using the trace that lost {best[0]} records")
    return best[1], best[2]


def device_ms(torch, fn, reps, match):
    """Device time per call, in ms, of the kernels whose names contain
    ``match`` (a name fragment, or a tuple of them), from a torch.profiler
    trace of ``reps`` calls. For a kernel shorter than its launch, CUDA
    events around back-to-back calls time the host's launches instead
    (``cuda_ms`` is kept beside it)."""
    matches = (match,) if isinstance(match, str) else tuple(match)
    kern, _ = kernel_trace(torch, fn, reps, f"device_ms {match!r}")
    us = sum(e.self_device_time_total for e in kern
             if any(mm in e.key for mm in matches))
    check(us > 0, f"the profiler saw no device time of {match!r}")
    return us / reps / 1e3


def compare_k1(torch, ops, ref, name, tables, codes, base, k, lut, scale):
    """K1's gathered entry against its plain version on the same CUDA
    tensors (``check_k1``'s rules), and a second call bit for bit.
    Returns max |err|."""
    dk, ik = ops.pq_adc_gather_topk(tables, codes, base, k, lut, scale)
    torch.cuda.synchronize()
    err = check_k1(torch, ops, ref, name, dk, ik, tables, codes, base, k, lut,
                   scale)
    d2, i2 = ops.pq_adc_gather_topk(tables, codes, base, k, lut, scale)
    check(torch.equal(d2, dk) and torch.equal(i2, ik),
          f"{name}: a second call differs")
    return err


def check_k1(torch, ops, ref, name, dk, ik, tables, codes, base, k, lut,
             scale):
    """K1's (dk, ik) against its plain version on the gathered inputs.
    int8: d2 and ids equal. f32/bf16: d2 within 1e-6 relative to the
    magnitude of the summands (|base| + sum_m max|T|, per query: the table
    terms and the base cancel, so the result itself can be far smaller),
    and every id the kernel returns scores, under the plain scorer, within
    that of the kernel's d2 (ids differ only on such near-ties). The
    (+inf, -1) slots must match. Returns max |err|."""
    dp, ip = ops.pq_adc_gather_topk_plain(tables, codes, base, k, lut, scale)
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), f"{name}: finite mask")
    check(torch.equal(ik[~fin], ip[~fin]), f"{name}: unfilled slots")
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    if lut == "int8":
        check(torch.equal(dk, dp), f"{name}: int8 d2 not bit-equal")
        check(torch.equal(ik, ip), f"{name}: int8 ids differ")
    else:
        fb = torch.where(torch.isfinite(base), base.abs(), 0.0)
        mag = fb.amax(dim=1) + tables.abs().amax(dim=2).sum(dim=1)  # (Q,)
        tol = (1e-6 * mag[:, None]).expand_as(dp)[fin]
        check(bool(((dk[fin] - dp[fin]).abs() <= tol).all()),
              f"{name}: d2 beyond 1e-6 of the summands (max err {err})")
        scores = ref.pq_adc_gather_scores_ref(tables, codes, base, lut, scale)
        got = torch.gather(scores, 1, ik.clamp_min(0))[fin]
        check(bool(((got - dk[fin]).abs() <= tol).all()),
              f"{name}: an id does not score its distance")
        same = float((ik == ip).float().mean())
        log(f"  {name}: ids equal on {same:.6f} of slots")
    log(f"  {name}: ok, max |d2 err| {err:.3e}")
    return err


def compare_k1_cells(torch, ops, ref, name, tables, probe, cd2p, codes_cell,
                     bias_cell, cand, k, lut, scale, cell_len=None,
                     live=None):
    """K1's cell-major entry: against its plain version (the padded scan's
    gather, then K1's plain version; ``cand`` -1 on the slots whose byte
    in the cell-major ``live`` map is 0) under ``check_k1``'s rules, bit
    for bit against K1's gathered entry on the gathered inputs (at every
    LUT type), and a second call bit for bit. Returns max |err|."""
    dk, ik = ops.pq_adc_cells_topk(tables, probe, cd2p, codes_cell,
                                   bias_cell, cand, k, lut, scale, cell_len,
                                   live)
    torch.cuda.synchronize()
    if live is not None:
        cand = torch.where(ref.live_slots(probe, live, cand.shape[1]), cand,
                           -1)
    codes, base = ref.gather_cells(probe, cand, cd2p, codes_cell, bias_cell)
    err = check_k1(torch, ops, ref, name, dk, ik, tables, codes, base, k, lut,
                   scale)
    da, ia = ops.pq_adc_gather_topk(tables, codes, base, k, lut, scale)
    check(torch.equal(dk, da) and torch.equal(ik, ia),
          f"{name}: not bit-equal to the gathered entry")
    d2, i2 = ops.pq_adc_cells_topk(tables, probe, cd2p, codes_cell,
                                   bias_cell, cand, k, lut, scale, cell_len,
                                   live)
    check(torch.equal(d2, dk) and torch.equal(i2, ik),
          f"{name}: a second call differs")
    log(f"  {name}: bit-equal to the gathered entry, repeats")
    return err


def cell_index(rng, nlist, sizes, m, kc, code_dtype=np.uint8):
    """A synthetic IVF-PQ cell layout from a seeded ``rng``: left-packed
    posting lists of the given cell ``sizes`` (ids 0.. in cell order), its
    cell-major codes and bias (0 on pads) and the cells' fills."""
    max_cell = int(max(1, sizes.max()))
    lists = np.full((nlist, max_cell), -1, np.int64)
    start = 0
    for c, n in enumerate(sizes):
        lists[c, :n] = np.arange(start, start + n)
        start += n
    codes_cell = rng.integers(0, kc, (nlist, max_cell, m)).astype(code_dtype)
    bias_cell = np.where(lists >= 0,
                         rng.uniform(-1, 1, (nlist, max_cell)), 0.0).astype(
                             np.float32)
    return lists, codes_cell, bias_cell, sizes.astype(np.int64)


def cell_probe(rng, nq, sizes, nprobe, lists, n_cand):
    """Seeded probes of ``nprobe`` distinct cells a query (denser cells
    more often, as real queries find them), ascending coarse distances, and
    the candidate ids of the probed slots padded with -1 to ``n_cand``
    (what ``probe_cells`` returns)."""
    w = sizes.astype(np.float64) + 1.0
    probe = np.stack([rng.choice(len(sizes), nprobe, replace=False,
                                 p=w / w.sum()) for _ in range(nq)])
    cd2p = np.sort(rng.uniform(0, 4, (nq, nprobe)).astype(np.float32), axis=1)
    cand = lists[probe].reshape(nq, -1)
    if cand.shape[1] < n_cand:
        cand = np.pad(cand, ((0, 0), (0, n_cand - cand.shape[1])),
                      constant_values=-1)
    return probe.astype(np.int64), cd2p, cand


def busy_share(torch, fn, reps, label, top=6, by=KERNEL_GROUPS):
    """Share of a window of ``reps`` calls of ``fn`` in which the card runs
    a kernel: the kernels' device time (one stream, so no overlap) from a
    complete trace (``kernel_trace``) over the host time of the window.
    The profiler slows the host, so the idle share it implies is an upper
    bound. Logs and returns the share, the kernels launched per call, the
    top kernels with their device µs per call and the device µs per call
    by the groups of ``by`` (the first whose fragment a kernel's name
    holds)."""
    kern, wall_us = kernel_trace(torch, fn, reps, label, warm=False)
    busy_us = sum(e.self_device_time_total for e in kern)
    groups = {}
    for e in kern:
        g = next((g for g, keys in by if any(k in e.key for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / reps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    out = {"busy_share": busy_us / wall_us,
           "device_us_per_call": busy_us / reps,
           "kernels_per_call": sum(e.count for e in kern) / reps,
           "top_kernels_us": [(e.key[:60], e.self_device_time_total / reps,
                               e.count / reps) for e in top],
           "device_us_by_group": groups}
    log(f"[trace] {label}: device busy {out['busy_share']:.3f} of the "
        f"window, {out['kernels_per_call']:.0f} kernels a call; top kernels "
        f"(us per call): "
        f"{[(n, round(t, 1), c) for n, t, c in out['top_kernels_us']]}")
    return out


def device_busy(torch, eng, queries, label, reps=10):
    """``busy_share`` of ``reps`` searches, after one warm-up search."""
    eng.search(queries, K)
    return busy_share(torch, lambda: eng.search(queries, K), reps, label)


def lm_serve(torch, tf, fa, params, cfg, tokens, steps, teacher=None,
             decode_cfg=None):
    """One prefill of ``tokens`` (B, S) into a fresh cache of LM_MAX_LEN
    slots, then ``steps`` greedy decode steps, each fed the last step's
    argmax over [:vocab] (as lm_family's smoke does), or ``teacher``'s
    token at that step when given; the decode runs ``decode_cfg`` when
    given (an MoE LM's dense combine), else ``cfg``. Returns (prefill
    logits, greedy tokens (B, steps + 1), K5 launches in the prefill, K5
    launches in the decode, the prefill's host ms, each decode step's ms
    by CUDA events)."""
    decode_cfg = cfg if decode_cfg is None else decode_cfg
    cache = tf.init_cache(cfg, tokens.shape[0], LM_MAX_LEN)
    torch.cuda.synchronize()
    n0 = fa.flash_attention_fwd.launches
    t0 = time.perf_counter()
    logits, cache = tf.lm_prefill(params, cfg, tokens, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n1 = fa.flash_attention_fwd.launches
    first = logits
    toks = [logits[:, :cfg.vocab].argmax(dim=-1)]
    step_ms = []
    for i in range(steps):
        feed = toks[-1] if teacher is None else teacher[:, i]
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        logits, cache = tf.lm_decode_step(params, decode_cfg, feed,
                                          tokens.shape[1] + i, cache)
        e.record()
        toks.append(logits[:, :cfg.vocab].argmax(dim=-1))
        torch.cuda.synchronize()
        step_ms.append(s.elapsed_time(e))
        check(bool(torch.isfinite(logits).all()), f"decode step {i}: "
              "non-finite logits")
    return (first, torch.stack(toks, dim=1), n1 - n0,
            fa.flash_attention_fwd.launches - n1, prefill_ms, step_ms)


def k5_timing(torch, fa, q, k, v, plain_reps=3):
    """K5 on (q, k, v) (causal, bf16, no window), second call on: its ms
    by CUDA events beside its plain version's (``plain_reps`` calls after
    one more), scaled_dot_product_attention (the library yardstick; the
    port never calls it) and the bound."""
    import torch.nn.functional as F
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    k5_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), reps=10)
    k5_plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v),
                       reps=plain_reps, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True)
    sdpa_err = float((sdpa.transpose(1, 2).float()
                      - fa.flash_attention_fwd(q, k, v).float()).abs().max())
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    bound, by, nops, nbytes = k5_bound(b, s, h, kvh, dh, None, 2)
    log(f"[timings] K5 {k5_ms:.4f} ms, plain {k5_plain:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms (max |diff| to K5 {sdpa_err:.3e}), bound "
        f"{bound:.4f} ms ({by}: {nops:.4g} ops, {nbytes} B) at B={b} "
        f"S={s} H={h} KV={kvh} dh={dh} bf16")
    return {"ms": k5_ms, "plain_ms": k5_plain, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by, "ops": nops, "bytes": nbytes,
            "sdpa_max_abs_diff": sdpa_err,
            "shape": {"b": b, "s": s, "h": h, "kv": kvh, "dh": dh}}


def lm_path(torch, tf, fa, lm_param_count, rms_norm, base_cfg, counters):
    """Path 3: ``base_cfg`` (TinyLlama-1.1B) at full width, bf16, random
    weights from seed 0, served with attn_impl="flash" (K5 in every
    prefill layer), held against the chunked route. Returns (result
    dict, K5 launches on the main run, K5's max |err| on the path's own
    q, k, v, K5 timing dict)."""
    dev = torch.device("cuda")
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    out = {"config": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ,
           "max_len": LM_MAX_LEN, "decode_steps": LM_DECODE}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = tf.lm_init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(dev)

    # the main run: counts zeroed just before, read just after
    for fn in counters:
        fn.launches = 0
    fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    logits, toks, n_pre, n_dec, pre_ms, step_ms = lm_serve(
        torch, tf, fa, params, cfg, tokens, LM_DECODE)
    launches = fa.flash_attention_fwd.launches
    routes = dict(fa.flash_attention_fwd.launches_by_route)
    out["k5_launches_by_route"] = routes
    check(routes["mma_bf16"] == launches, f"K5's bf16 launches did not all "
          f"take the tensor-core route: {routes}")
    others = {fn.__name__: fn.launches for fn in counters
              if fn is not fa.flash_attention_fwd}
    log(f"[path 3] {cfg.name} prefill {LM_BATCH} x {LM_SEQ} + {LM_DECODE} "
        f"decode steps: K5 launches {n_pre} in the prefill, {n_dec} in the "
        f"decode; other kernels {others}")
    check(n_pre == cfg.n_layers and n_dec == 0 and launches == n_pre,
          f"K5 launched {n_pre} times in the prefill (want {cfg.n_layers}) "
          f"and {n_dec} in the decode (want 0)")
    check(not any(others.values()), "a search kernel ran on path 3")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "bad tokens")
    out["k5_launches_prefill"] = n_pre
    out["k5_launches_decode"] = n_dec
    out["first_prefill_ms"] = pre_ms
    out["decode_step_ms"] = {"p50": float(np.median(step_ms)),
                             "p90": float(np.percentile(step_ms, 90)),
                             "first": step_ms[0]}
    out["decode_tok_per_s"] = LM_BATCH / (out["decode_step_ms"]["p50"] / 1e3)

    # the same prefill on the chunked route, decoding the flash route's
    # tokens (teacher-forced), so each step compares one context
    cfg_c = dataclasses.replace(cfg, attn_impl="chunked")
    logits_c, toks_c, n_pre_c, _, _, _ = lm_serve(
        torch, tf, fa, params, cfg_c, tokens, LM_DECODE, teacher=toks)
    check(n_pre_c == 0, "K5 ran on the chunked route")
    ldiff = float((logits.float() - logits_c.float()).abs().max())
    agree = float((toks_c == toks).float().mean())
    out["flash_vs_chunked"] = {
        "logits_max_abs_diff": ldiff, "logits_abs_max":
        float(logits.float().abs().max()), "greedy_agreement": agree,
        "tolerance": {"logits_atol": LM_LOGIT_ATOL,
                      "agreement_floor": LM_AGREE_FLOOR}}
    log(f"[path 3] flash vs chunked: last-position logits max |diff| "
        f"{ldiff:.4f} (|logits| up to {out['flash_vs_chunked']['logits_abs_max']:.3f}),"
        f" greedy tokens agree on {agree:.4f} of {toks.numel()}")
    check(ldiff <= LM_LOGIT_ATOL, f"flash and chunked logits differ by "
          f"{ldiff} > {LM_LOGIT_ATOL}")
    check(agree >= LM_AGREE_FLOOR, f"greedy agreement {agree} < "
          f"{LM_AGREE_FLOOR}")

    # the embedding hook on one batch (K5 again in every layer)
    n0 = fa.flash_attention_fwd.launches
    emb = tf.lm_embed(params, cfg, tokens)
    torch.cuda.synchronize()
    check(tuple(emb.shape) == (LM_BATCH, cfg.d_model)
          and bool(torch.isfinite(emb).all())
          and fa.flash_attention_fwd.launches - n0 == cfg.n_layers,
          f"lm_embed: {tuple(emb.shape)}, finite "
          f"{bool(torch.isfinite(emb).all())}, "
          f"{fa.flash_attention_fwd.launches - n0} K5 launches")
    log(f"[path 3] lm_embed {tuple(emb.shape)} finite, "
        f"{cfg.n_layers} K5 launches")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # K5 on the path's own layer-0 q, k, v, at bf16 and upcast to f32
    log("[K5 main]")
    lp0 = {key: t[0] for key, t in params["runs"][0].items()}
    with torch.inference_mode():
        x = rms_norm(params["embed"][tokens].to(cfg.dtype), lp0["ln1"])
        q, k, v = tf._qkv(cfg, x, lp0, torch.arange(LM_SEQ, device=dev),
                          None)
    out["k5_main_checks"] = {}
    err = compare_k5(torch, fa, "K5 main bf16", q, k, v, None,
                     out["k5_main_checks"])
    err = max(err, compare_k5(torch, fa, "K5 main f32", q.float(),
                              k.float(), v.float(), None,
                              out["k5_main_checks"]))

    # timings, second call on
    k5 = k5_timing(torch, fa, q, k, v)
    nops = k5["ops"]

    def prefill_once(c):
        cache = tf.init_cache(c, LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.lm_prefill(params, c, tokens, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    pre = [prefill_once(cfg) for _ in range(3)]
    pre_c = [prefill_once(cfg_c) for _ in range(2)]
    model_flops = (2 * lm_param_count(cfg) * LM_BATCH * LM_SEQ
                   + cfg.n_layers * nops)
    p50 = float(np.median(pre))
    out["prefill_ms"] = {"flash": pre, "chunked": pre_c}
    out["prefill_tok_per_s"] = LM_BATCH * LM_SEQ / (p50 / 1e3)
    out["prefill_model_flops"] = model_flops
    out["prefill_peak_share"] = model_flops / (p50 / 1e3) / BF16_OPS_PER_S
    log(f"[timings] prefill {LM_BATCH} x {LM_SEQ}: flash "
        f"{[round(t, 2) for t in pre]} ms, chunked "
        f"{[round(t, 2) for t in pre_c]} ms; {out['prefill_tok_per_s']:.0f} "
        f"tok/s; {model_flops:.4g} FLOPs = {out['prefill_peak_share']:.4f} "
        f"of the bf16 peak")
    log(f"[timings] decode p50 {out['decode_step_ms']['p50']:.3f} ms a step "
        f"(p90 {out['decode_step_ms']['p90']:.3f}, first "
        f"{out['decode_step_ms']['first']:.3f}), "
        f"{out['decode_tok_per_s']:.1f} tok/s at batch {LM_BATCH}; peak "
        f"memory {out['peak_mem_gb']:.2f} GB (before path 3: "
        f"{out['mem_before_gb']:.2f} GB)")

    # the card's busy share: one prefill, then 10 decode steps
    cache = tf.init_cache(cfg, LM_BATCH, LM_MAX_LEN)
    step = iter(range(LM_SEQ, LM_MAX_LEN))
    nxt = toks[:, 0]
    out["busy"] = {
        "prefill": busy_share(
            torch, lambda: tf.lm_prefill(params, cfg, tokens, cache), 1,
            "path 3 prefill"),
        "decode": busy_share(
            torch, lambda: tf.lm_decode_step(params, cfg, nxt, next(step),
                                             cache), 10, "path 3 decode")}
    return out, launches, err, k5


def k6_inputs(torch, seed, t, d, v, vocab, dtype, tied=False):
    """h (T, D) ~ N(0, 1) and a head w (D, V) ~ N(0, 1/D), so logits are
    ~N(0, 1) as at initialisation; labels (T,) int64 below ``vocab``. A
    tied head is the transposed view of a (V, D) embedding, D contiguous."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d), dtype=np.float32)
    w = (rng.standard_normal((v, d) if tied else (d, v), dtype=np.float32)
         / np.sqrt(d))
    labels = rng.integers(0, vocab, t)
    h, w, labels = (torch.from_numpy(a).to("cuda") for a in (h, w, labels))
    w = w.to(dtype)
    return h.to(dtype), (w.T if tied else w), labels


def compare_k6(torch, fce, name, h, w, labels, vocab):
    """K6 against its plain version on the same CUDA tensors: the launch
    counted on the route ``kernel_route`` names (bf16 h and w on the
    tensor cores, else the f32 kernel), per-token loss within K6_TOL (the
    same f32 products, summed in another order; a bf16 product is exact in
    f32, so bf16 inputs take the same tolerance), and bit-equal on a
    second call (no atomics). Returns max |err|."""
    route = fce.kernel_route(h.dtype, w.dtype)
    n0 = fce.fused_ce_fwd.launches_by_route[route]
    got = fce.fused_ce_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    check(fce.fused_ce_fwd.launches_by_route[route] == n0 + 1,
          f"{name}: not launched on the {route} route")
    want = fce.fused_ce_fwd_plain(h, w, labels, vocab)
    check(got.dtype == torch.float32 and got.shape == labels.shape,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= K6_TOL["atol"] + K6_TOL["rtol"] * want.abs()).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"{name}: beyond {K6_TOL} (max err {err})")
    check(torch.equal(fce.fused_ce_fwd(h, w, labels, vocab), got),
          f"{name}: a second call differs")
    log(f"  {name}: ok on the {route} route, max |err| {err:.3e} (loss up "
        f"to {float(want.abs().max()):.2f})")
    return err


def edge_cases_k6(torch, fce):
    """K6 on T = 1, 63 (ragged) and 4096; (D, V, vocab) of 64 x 256 with
    and without a masked tail, a ragged V (1000), D 2048 with V 1000 and a
    masked tail, and TinyLlama's 2048 x 32000; f32 and bf16; int32 labels
    once; a tied head (D contiguous); and Gemma3-4B's tied head, embed.T
    (2560, 262144) bf16, at T = 512."""
    err = 0.0
    i = 0
    for t in (1, 63, 4096):
        for d, v, vocab in ((64, 256, 256), (64, 256, 200), (64, 1000, 1000),
                            (2048, 1000, 937), (2048, 32000, 32000)):
            for name, dt in (("f32", torch.float32),
                             ("bf16", torch.bfloat16)):
                i += 1
                h, w, labels = k6_inputs(torch, 20 + i, t, d, v, vocab, dt)
                err = max(err, compare_k6(
                    torch, fce, f"K6 edge {name} T={t} D={d} V={v} "
                    f"vocab={vocab}", h, w, labels, vocab))
    h, w, labels = k6_inputs(torch, 5, 63, 64, 1000, 900, torch.float32)
    err = max(err, compare_k6(torch, fce, "K6 edge int32 labels", h, w,
                              labels.int(), 900))
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        h, w, labels = k6_inputs(torch, 6, 300, 2048, 32000, 31000, dt,
                                 tied=True)
        err = max(err, compare_k6(torch, fce, f"K6 edge tied {name} T=300 "
                                  "D=2048 V=32000 vocab=31000", h, w, labels,
                                  31000))
    h, w, labels = k6_inputs(torch, 7, 512, 2560, 262144, 262144,
                             torch.bfloat16, tied=True)
    err = max(err, compare_k6(torch, fce, "K6 edge gemma3-4b tied head "
                              "embed.T (2560, 262144) bf16 T=512", h, w,
                              labels, None))
    return err


def k6_bound(t, d, v, h_bytes, w_bytes):
    """The least time of one K6 call: the larger of its operations (a
    multiply-add per (row, column, depth)) at the bf16 tensor peak and its
    bytes (h, w and the int64 labels read once, the f32 loss written
    once) at the HBM rate. Returns (ms, by, ops, bytes)."""
    nops = 2 * t * d * v
    nbytes = t * d * h_bytes + d * v * w_bytes + t * 8 + t * 4
    t_ops, t_bytes = nops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nops, nbytes)


def train_flops(cfg, lm_param_count, k5_nops):
    """Model FLOPs of one training step of TRAIN_BATCH x TRAIN_SEQ tokens:
    6 * active params * tokens (every parameter of a dense model, the
    embedding and the head included, and an MoE's top-k experts: forward 2,
    backward 4), plus each layer's causal attention (``k5_nops``, the
    multiply-adds of q.k and p.v over the pairs the mask keeps) four times:
    the forward, the backward (twice the forward) and the remat
    recompute."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return (6 * lm_param_count(cfg, active_only=True) * tokens
            + 4 * cfg.n_layers * k5_nops)


def k5_function_check(torch, fa, cfg):
    """K5's autograd.Function against the all-plain route (the chunked
    forward and its autograd backward) at ``cfg``'s heads, B 2, S 1024,
    bf16. The loss is linear in the output (sum(out * r)), so the
    cotangent does not depend on which forward ran, and both backwards
    are the same chunked recompute: the gradients agree to
    K5_GRAD_RTOL of their largest entry. Returns the max relative err."""
    rng = np.random.default_rng(8)
    shapes = ((2, 1024, cfg.n_heads, cfg.d_head),
              (2, 1024, cfg.n_kv_heads, cfg.d_head),
              (2, 1024, cfg.n_kv_heads, cfg.d_head))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to("cuda").to(torch.bfloat16) for s in shapes)
    r = torch.from_numpy(rng.standard_normal(shapes[0], dtype=np.float32)
                         ).to("cuda")
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_fwd_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        grads.append(torch.autograd.grad((out.float() * r).sum(), leaves))
    torch.cuda.synchronize()
    err = 0.0
    for name, got, want in zip("qkv", *grads):
        scale = float(want.float().abs().max())
        e = float((got.float() - want.float()).abs().max()) / scale
        check(got.dtype == torch.bfloat16 and e <= K5_GRAD_RTOL,
              f"K5 Function d{name}: max |err| {e} of max |grad| {scale}")
        err = max(err, e)
    log(f"[K5 Function] B=2 S=1024 H={cfg.n_heads} KV={cfg.n_kv_heads} "
        f"dh={cfg.d_head} bf16: dq, dk, dv within {err:.3e} of the "
        "all-plain route (relative to max |grad|)")
    return err


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / torch.linalg.vector_norm(b.float()))


def reference_loss(torch, tf, fce, cfg, params, batch):
    """The reference route of lm_loss: ``cfg``'s attention (chunked) and
    the plain materialized-logits CE (``ce_ref``) over the same sequence
    chunks and head (the tied embed.T or lm_head), plus an MoE config's
    aux term."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    h, aux = tf._final_hidden(cfg, params, tokens)
    head = tf._head(cfg, params)
    ck = min(cfg.seq_chunk, s)
    total = 0.0
    for c0 in range(0, s, ck):
        total = total + fce.ce_ref(h[:, c0:c0 + ck].reshape(-1, cfg.d_model),
                                   head, labels[:, c0:c0 + ck].reshape(-1),
                                   cfg.vocab).sum()
    loss = total / (b * s)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


def restart_drill(torch, tf, optim, data, runtime, smoke_cfg):
    """run_with_restarts at ``smoke_cfg`` (TinyLlama's SMOKE, flash) on the
    card: DRILL_STEPS steps, a checkpoint every DRILL_EVERY, once with a
    failure injected at DRILL_FAIL and once without. Returns (max |param
    diff|, bit-equal?, restarts seen)."""
    import tempfile
    cfg = dataclasses.replace(smoke_cfg, attn_impl="flash")
    batches = list(data.lm_token_batches(SEED, 4, 64, cfg.vocab,
                                         n_steps=DRILL_STEPS))
    step = optim.make_train_step(
        lambda p, b: tf.lm_train_forward(p, cfg, b),
        optim.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=DRILL_STEPS))
    calls = []

    def step_fn(state, i):
        calls.append(i)
        _, p, o = step(state["params"], state["opt"], batches[i])
        return {"params": p, "opt": o}

    finals = []
    build_dir = os.path.join(HERE, "build")
    os.makedirs(build_dir, exist_ok=True)
    for fail_at in ((), (DRILL_FAIL,)):
        params = tf.lm_init_params(cfg, seed=SEED)
        with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
            finals.append(runtime.run_with_restarts(
                step_fn, {"params": params,
                          "opt": optim.init_opt_state(params)},
                DRILL_STEPS, ckpt, ckpt_every=DRILL_EVERY,
                injector=runtime.FailureInjector(fail_at)))
    # the faulty run replays from the checkpoint after step DRILL_FAIL - 1
    # rounded down to the checkpoint period
    replayed = len(calls) - 2 * DRILL_STEPS
    leaves = [(k, a.detach(), b.detach()) for (k, a), (_, b) in zip(
        _keyed(finals[0]), _keyed(finals[1]))]
    diff = max(float((a.float() - b.float()).abs().max())
               for _, a, b in leaves)
    same = all(torch.equal(a, b) for _, a, b in leaves)
    check(int(finals[1]["opt"]["step"]) == DRILL_STEPS,
          "the drill did not reach its last step")
    check(diff <= DRILL_ATOL, f"restart drill: params differ by {diff} > "
          f"{DRILL_ATOL}")
    log(f"[path 4] restart drill ({cfg.name}, {DRILL_STEPS} steps, "
        f"checkpoint every {DRILL_EVERY}, failure at step {DRILL_FAIL}): "
        f"{replayed} steps replayed; final params within {diff:.3e} of the "
        f"uninterrupted run (bit-equal: {same})")
    return diff, same, replayed


def train_parts(torch, fa, fce, optim, cfg, params, opt):
    """Device time (CUDA events) of the parts of a step at path 4's
    shapes: one layer's attention backward (the Function's chunked
    recompute and autograd), one K6 forward and one CE backward (T =
    B * seq_chunk), and one AdamW update of every parameter (on the
    trained state, which it moves once more)."""
    rng = np.random.default_rng(9)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, n, cfg.d_head), dtype=np.float32)).to("cuda")
        .to(torch.bfloat16).requires_grad_()
        for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    ct = torch.ones_like(q)
    out = fa.flash_attention(q, k, v)
    attn_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), ct, retain_graph=True), reps=2, warmup=1)
    del out
    t = b * cfg.seq_chunk
    h = torch.from_numpy(rng.standard_normal((t, cfg.d_model),
                                             dtype=np.float32)).to("cuda")
    h = h.to(torch.bfloat16).requires_grad_()
    head = params["lm_head"]
    lab = torch.from_numpy(rng.integers(0, cfg.vocab, t)).to("cuda")
    loss = fce.fused_ce(h, head, lab, cfg.vocab).sum()
    ce_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        loss, (h, head), retain_graph=True), reps=2, warmup=1)
    # the parameters stand in for a gradient: bf16, of the right shapes
    adam = cuda_ms(torch, lambda: optim.adamw_update(
        params, opt, params, optim.AdamWConfig()), reps=2, warmup=1)
    parts = {"attention_backward_one_layer": attn_bwd,
             "ce_backward_one_call": ce_bwd, "adamw_update": adam}
    log(f"[timings] path 4 parts (ms): attention backward of one layer "
        f"{attn_bwd:.1f} (x {cfg.n_layers} a step), CE backward of one "
        f"chunk {ce_bwd:.1f} (x {TRAIN_SEQ // cfg.seq_chunk}), AdamW "
        f"update {adam:.1f}")
    return parts


def _keyed(tree):
    from repro_torch._tree import keyed_leaves
    return keyed_leaves(tree)


def lm_train_run(torch, mods, base_cfg, kept, counters, tag, n_batches,
                 snap=None):
    """The training run of paths 4 and 13: ``base_cfg`` at full width and
    depth, bf16, random weights from seed 0, trained with attn_impl="flash"
    (K5 forward and its remat recompute in every layer, K6 over each
    sequence chunk's head) and AdamW. Step 0's loss and the gradients that
    ``kept`` picks are held against the chunked route with the plain CE
    (TRAIN_LOSS_ATOL, TRAIN_GRAD_REL); then TRAIN_STEPS steps, every count
    zeroed just before, each step checked for its K5 / K6 launches, both on
    their bf16 tensor-core routes, no other kernel, and finite losses and
    parameters. ``n_batches`` (>= TRAIN_STEPS) batches are drawn. Given a
    dict ``snap``, the losses and a host copy of the parameters after
    SHARD_TRAIN_STEPS steps go into it (path 14 (a) holds its steps
    against them). Returns (result dict, (params, opt, step, batches), K5
    launches, K6 launches)."""
    tf, fa, fce, optim, data, lm_param_count = mods
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    cfg_c = dataclasses.replace(base_cfg, attn_impl="chunked")
    out = {"config": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "seq_chunk": cfg.seq_chunk,
           "remat": cfg.remat}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    params = tf.lm_init_params(cfg, seed=SEED)
    batches = list(data.lm_token_batches(SEED, TRAIN_BATCH, TRAIN_SEQ,
                                         cfg.vocab, n_steps=n_batches))
    want5 = cfg.n_layers * (2 if cfg.remat else 1)
    want6 = TRAIN_SEQ // cfg.seq_chunk

    def loss_fn(p, b):
        return tf.lm_train_forward(p, cfg, b)

    # step 0's loss and gradient on both routes, before any update
    n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
    loss_f, grads = optim.value_and_grad(loss_fn, params, batches[0])
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches - n5 == want5
          and fce.fused_ce_fwd.launches - n6 == want6,
          f"{cfg.name} step 0's gradient: K5 / K6 launched "
          f"{fa.flash_attention_fwd.launches - n5} / "
          f"{fce.fused_ce_fwd.launches - n6} times, want {want5} / {want6}")
    gnorm0 = float(optim.global_norm(grads))
    keep = kept(grads)
    del grads
    n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
    loss_r, grads_r = optim.value_and_grad(
        lambda p, b: reference_loss(torch, tf, fce, cfg_c, p, b), params,
        batches[0])
    torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches == n5
          and fce.fused_ce_fwd.launches == n6, "a kernel ran on the "
          "reference route")
    ref = kept(grads_r)
    gnorm_r = float(optim.global_norm(grads_r))
    del grads_r
    dloss = abs(float(loss_f) - float(loss_r))
    rels = {k: rel_l2(torch, keep[k], ref[k]) for k in keep}
    del keep, ref
    out["step0"] = {"loss": float(loss_f), "loss_reference": float(loss_r),
                    "abs_dloss": dloss, "grad_norm": gnorm0,
                    "grad_norm_reference": gnorm_r, "grad_rel_l2": rels,
                    "tolerance": {"loss_atol": TRAIN_LOSS_ATOL,
                                  "grad_rel_l2": TRAIN_GRAD_REL}}
    log(f"[{tag}] {cfg.name} step 0: loss {float(loss_f):.5f} (flash + K6) "
        f"vs {float(loss_r):.5f} (chunked + plain CE), |dloss| {dloss:.3e}; "
        f"grad norm {gnorm0:.4f} vs {gnorm_r:.4f}; grad rel L2 "
        f"{ {k: round(v, 6) for k, v in rels.items()} }")
    check(np.isfinite(float(loss_f)) and np.isfinite(gnorm0),
          "step 0: non-finite loss or grad norm")
    check(dloss <= TRAIN_LOSS_ATOL, f"|dloss| {dloss} > {TRAIN_LOSS_ATOL}")
    check(all(v <= TRAIN_GRAD_REL for v in rels.values()),
          f"grad rel L2 {rels} beyond {TRAIN_GRAD_REL}")

    # the main run: TRAIN_STEPS steps, counts zeroed just before
    step = optim.make_train_step(loss_fn, optim.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
    opt = optim.init_opt_state(params)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    fce.fused_ce_fwd.launches_by_route = dict.fromkeys(fce.ROUTES, 0)
    losses, step_ms, per_step, losses_t = [], [], [], []
    for i in range(TRAIN_STEPS):
        n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        losses_t.append(loss)
        per_step.append((fa.flash_attention_fwd.launches - n5,
                         fce.fused_ce_fwd.launches - n6))
        log(f"[{tag}] {cfg.name} step {i}: loss {losses[-1]:.5f}, "
            f"{step_ms[-1]:.1f} ms, K5 {per_step[-1][0]} / K6 "
            f"{per_step[-1][1]} launches")
        if snap is not None and i + 1 == SHARD_TRAIN_STEPS:
            snap["losses"] = [loss.clone() for loss in losses_t]
            snap["params"] = {key: p.detach().to("cpu", copy=True)
                              for key, p in _keyed(params)}
    k5_launches = fa.flash_attention_fwd.launches
    k6_launches = fce.fused_ce_fwd.launches
    routes5 = dict(fa.flash_attention_fwd.launches_by_route)
    routes6 = dict(fce.fused_ce_fwd.launches_by_route)
    others = {fn.__name__: fn.launches for fn in counters
              if fn not in (fa.flash_attention_fwd, fce.fused_ce_fwd)}
    out["k5_launches_by_route"], out["k6_launches_by_route"] = routes5, routes6
    check(all(p == (want5, want6) for p in per_step),
          f"launches per step {per_step}, want ({want5}, {want6})")
    check(routes5["mma_bf16"] == k5_launches and routes6["bf16"] ==
          k6_launches, f"K5 {routes5} / K6 {routes6} by route: {tag} takes "
          "the bf16 tensor-core routes only")
    check(not any(others.values()), f"another kernel ran on {tag}: "
          f"{others}")
    check(all(np.isfinite(x) for x in losses), f"non-finite loss {losses}")
    with torch.no_grad():
        pnorm = float(optim.global_norm(params))
    check(np.isfinite(pnorm) and int(opt["step"]) == TRAIN_STEPS,
          "non-finite parameters after training")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    p50 = float(np.median(step_ms[1:]))
    _, _, k5_nops, _ = k5_bound(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_head, None, 2)
    flops = train_flops(cfg, lm_param_count, k5_nops)
    out.update({
        "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
        "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "model_flops": flops, "peak_share": flops / (p50 / 1e3)
        / BF16_OPS_PER_S, "launches_per_step": per_step,
        "param_norm_after": pnorm})
    log(f"[{tag}] {cfg.name} train {TRAIN_BATCH} x {TRAIN_SEQ}: step p50 "
        f"{p50:.1f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
        f"{step_ms[0]:.1f}), {out['tok_per_s']:.0f} tok/s, {flops:.4g} model "
        f"FLOPs = {out['peak_share']:.4f} of the bf16 peak; peak memory "
        f"{out['peak_mem_gb']:.2f} GB (before: {out['mem_before_gb']:.2f} "
        f"GB); K5 {k5_launches} ({routes5}), K6 {k6_launches} ({routes6}) "
        "launches")
    return out, (params, opt, step, batches), k5_launches, k6_launches


def train_path(torch, mods, base_cfg, smoke_cfg, counters):
    """Path 4: ``base_cfg`` (TinyLlama-1.1B) through ``lm_train_run``, then
    one step under the profiler, K6 on the path's own inputs, the parts of
    a step and the restart drill.
    Returns (result dict, K6 launches on the main run, K5 launches on the
    main run, K6's max |err| on the path's own inputs, K6 timing dict,
    the K5 Function's max relative err)."""
    import torch.nn.functional as F
    tf, fa, fce, optim, data, runtime, lm_param_count = mods
    k5_fn_err = k5_function_check(torch, fa, base_cfg)
    out, (params, opt, step, batches), k5_launches, k6_launches = \
        lm_train_run(torch, (tf, fa, fce, optim, data, lm_param_count),
                     base_cfg, lambda g: {
                         "lm_head": g["lm_head"],
                         "runs[0].wq": g["runs"][0]["wq"],
                         "embed": g["embed"]},
                     counters, "path 4", TRAIN_STEPS + 1)
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")

    # one more step under the profiler: where the step's time goes
    out["busy"] = busy_share(
        torch, lambda: step(params, opt, batches[TRAIN_STEPS]), 1,
        "path 4 train step", top=12)
    by_group = out["busy"]["device_us_by_group"]
    log(f"[trace] path 4 device ms by group: "
        f"{ {k: round(v / 1e3, 1) for k, v in by_group.items()} }")

    # K6 on the path's own inputs: the first sequence chunk of batch 0
    log("[K6 main]")
    with torch.no_grad():
        h = tf._final_hidden(cfg, params, batches[0]["tokens"])[0]
        hc = h[:, :cfg.seq_chunk].reshape(-1, cfg.d_model)
        del h
        head = params["lm_head"].detach()
        lab = batches[0]["labels"][:, :cfg.seq_chunk].reshape(-1)
        err = compare_k6(torch, fce, "K6 main bf16", hc, head, lab,
                         cfg.vocab)
        err = max(err, compare_k6(torch, fce, "K6 main f32", hc.float(),
                                  head.float(), lab, cfg.vocab))
        t = hc.shape[0]
        k6_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd(hc, head, lab,
                                                        cfg.vocab), reps=10)
        hc32, head32 = hc.float(), head.float()
        k6_f32_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd(
            hc32, head32, lab, cfg.vocab), reps=5)
        del hc32, head32
        plain_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd_plain(
            hc, head, lab, cfg.vocab), reps=3, warmup=1)
        ce = F.cross_entropy((hc @ head).float(), lab, reduction="none")
        ce_diff = float((ce - fce.fused_ce_fwd(hc, head, lab,
                                               cfg.vocab)).abs().max())
        yard_ms = cuda_ms(torch, lambda: F.cross_entropy(
            (hc @ head).float(), lab, reduction="none"), reps=10)
    bound, by, nops, nbytes = k6_bound(t, cfg.d_model, head.shape[1], 2, 2)
    f32_bound = max(nops / F32_OPS_PER_S,
                    (nbytes * 2 - t * 12) / HBM_BYTES_PER_S) * 1e3
    log(f"[timings] K6 bf16 route {k6_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by}: {nops:.4g} ops, {nbytes} B) at T={t} "
        f"D={cfg.d_model} V={head.shape[1]} bf16; no single PyTorch call "
        f"computes K6; yardstick cross_entropy((h @ w).float()) "
        f"{yard_ms:.4f} ms (two calls, bf16 logits; max |diff| to K6 "
        f"{ce_diff:.3e}); the f32 route on the same values upcast "
        f"{k6_f32_ms:.4f} ms (its bound at the f32 CUDA-core peak "
        f"{f32_bound:.4f} ms)")
    k6 = {"ms": k6_ms, "f32_route_ms": k6_f32_ms,
          "f32_route_bound_ms": f32_bound, "plain_ms": plain_ms,
          "bound_ms": bound, "bound_by": by, "ops": nops, "bytes": nbytes,
          "yardstick_cross_entropy_ms": yard_ms,
          "yardstick_max_abs_diff": ce_diff, "shape": [t, cfg.d_model,
                                                       head.shape[1]]}
    del hc, head
    out["parts_ms"] = train_parts(torch, fa, fce, optim, cfg, params, opt)
    del params, opt
    torch.cuda.empty_cache()

    diff, same, replayed = restart_drill(torch, tf, optim, data, runtime,
                                         smoke_cfg)
    out["restart_drill"] = {"steps": DRILL_STEPS, "ckpt_every": DRILL_EVERY,
                            "fail_at": DRILL_FAIL, "replayed": replayed,
                            "max_abs_param_diff": diff, "bit_equal": same,
                            "tolerance": DRILL_ATOL}
    return out, k6_launches, k5_launches, err, k6, k5_fn_err


def edge_cases(torch, ops, ref):
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    err = 0.0

    def put(a):
        return torch.from_numpy(a).to(dev)

    # the block plan: runs of many chunks a block (k 1 to 1024, the list
    # sorted in registers up to k 256 and in shared memory past it), and a
    # batch of one query split over many blocks
    for lut in ("f32", "bf16", "int8"):
        for (nq, c, m, kc, k, masked) in ((9, 517, 8, 64, 12, 5),
                                          (5, 130, 16, 256, 40, 110),
                                          (33, 5003, 16, 256, 64, 700),
                                          (4, 300_000, 16, 256, 100, 0),
                                          (3, 200_000, 16, 256, 1, 0),
                                          (2, 150_000, 16, 256, 256, 1000),
                                          (2, 60_000, 16, 256, 1024, 0),
                                          (1, 400_000, 16, 256, 64, 5000)):
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (nq, c, m)).astype(np.uint8)
            base = rng.uniform(size=(nq, c)).astype(np.float32)
            if masked:
                base[:, -masked:] = np.inf
                base[::2, :masked] = np.inf
            err = max(err, compare_k1(torch, ops, ref,
                                      f"edge {lut} Q={nq} C={c} M={m} k={k}",
                                      put(t), put(codes), put(base), k, lut,
                                      None))
    # exact int8 ties: integer tables, caller scale 1, constant base
    t = rng.integers(-3, 4, (6, 4, 8)).astype(np.float32)
    codes = rng.integers(0, 8, (6, 3000, 4)).astype(np.uint8)
    compare_k1(torch, ops, ref, "edge int8 exact ties", put(t), put(codes),
               put(np.zeros((6, 3000), np.float32)), 50, "int8",
               torch.ones(6, device=dev))
    # int32 codes (K > 256): ragged C, k = 1 and k = C, M 8 (16-byte loads)
    # and M 6 (one code at a time)
    for lut in LUTS:
        for (nq, c, m, kc, k) in ((7, 3001, 8, 512, 1), (5, 1337, 8, 1024, 64),
                                  (3, 777, 6, 1024, 777)):
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (nq, c, m)).astype(np.int32)
            base = rng.uniform(size=(nq, c)).astype(np.float32)
            base[:, -5:] = np.inf
            err = max(err, compare_k1(torch, ops, ref,
                                      f"edge int32 {lut} Q={nq} C={c} M={m} "
                                      f"K={kc} k={k}", put(t), put(codes),
                                      put(base), k, lut, None))
    return err


def edge_cases_k1_cells(torch, ops, ref):
    """K1's cell-major entry on synthetic cell layouts (``cell_index``,
    ``cell_probe``) at every LUT type, with the cells' fills (left-packed
    lists) and with the candidate ids (``cand``): empty cells, ragged Q and
    Q 1, cand wider than P * max_cell and narrower, k larger than a cell,
    int32 codes (K 1024, M 8 and M 6), and lists with holes (cand only);
    and with the fills and a cell-major live byte map killing 30% of the
    posting slots, as a streaming store's tombstones do."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    err = 0.0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = (  # nq, nlist, max size, nprobe, m, kc, k, extra slots, dtype
        (9, 64, 300, 8, 16, 256, 40, 0, np.uint8),     # ragged Q, empties
        (1, 64, 300, 8, 16, 256, 64, 0, np.uint8),     # Q 1
        (5, 32, 90, 4, 16, 256, 256, 0, np.uint8),     # k > a cell, k > #
        (6, 48, 200, 6, 16, 256, 30, 513, np.uint8),   # cand wider
        (6, 48, 200, 6, 16, 256, 30, -50, np.uint8),   # cand narrower
        (7, 40, 150, 5, 8, 1024, 64, 0, np.int32),     # int32, 16-byte rows
        (4, 40, 150, 5, 6, 1024, 1, 0, np.int32))      # int32, M 6
    for lut in LUTS:
        for (nq, nlist, top, nprobe, m, kc, k, extra, cdt) in cases:
            sizes = rng.integers(0, top + 1, nlist)
            sizes[::7] = 0                               # empty cells
            lists, codes_cell, bias_cell, fill = cell_index(rng, nlist, sizes,
                                                            m, kc, cdt)
            max_cell = lists.shape[1]
            n_cand = nprobe * max_cell + max(extra, 0)
            probe, cd2p, cand = cell_probe(rng, nq, sizes, nprobe, lists,
                                           n_cand)
            if extra < 0:
                cand = cand[:, :nprobe * max_cell + extra]
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            args = (put(t), put(probe), put(cd2p), put(codes_cell),
                    put(bias_cell), put(cand))
            tag = (f"K1 cells {lut} Q={nq} P={nprobe} max_cell={max_cell} "
                   f"M={m} K={kc} k={k} C={cand.shape[1]}")
            err = max(err, compare_k1_cells(
                torch, ops, ref, tag + " fills", *args, k, lut, None,
                put(fill)))
            err = max(err, compare_k1_cells(torch, ops, ref, tag + " cand",
                                            *args, k, lut, None))
            live = rng.uniform(size=bias_cell.shape) >= 0.3
            err = max(err, compare_k1_cells(
                torch, ops, ref, tag + " fills + live", *args, k, lut, None,
                put(fill), put(live.astype(np.uint8))))
    # posting lists with holes: only the cand route may read them
    sizes = rng.integers(50, 200, 32)
    lists, codes_cell, bias_cell, _ = cell_index(rng, 32, sizes, 16, 256)
    holes = rng.uniform(size=lists.shape) < 0.2
    lists = np.where(holes, -1, lists)
    bias_cell = np.where(lists >= 0, bias_cell, 0.0).astype(np.float32)
    probe, cd2p, cand = cell_probe(rng, 5, sizes, 6, lists,
                                   6 * lists.shape[1])
    t = (rng.uniform(size=(5, 16, 256)) * 5).astype(np.float32)
    for lut in LUTS:
        err = max(err, compare_k1_cells(
            torch, ops, ref, f"K1 cells {lut} lists with holes, cand",
            put(t), put(probe), put(cd2p), put(codes_cell), put(bias_cell),
            put(cand), 50, lut, None))
    # probed ids outside [0, nlist): -1 for a cell another rank owns (the
    # shard-local ivfpq scan) and ids past the block; no slot is read
    sizes = rng.integers(0, 200, 40)
    lists, codes_cell, bias_cell, fill = cell_index(rng, 40, sizes, 16, 256)
    probe, cd2p, cand = cell_probe(rng, 7, sizes, 6, lists,
                                   6 * lists.shape[1])
    probe[:, 1] = -1
    probe[::2, 4] = 40 + 3
    live = (rng.uniform(size=bias_cell.shape) >= 0.3).astype(np.uint8)
    t = (rng.uniform(size=(7, 16, 256)) * 5).astype(np.float32)
    args = (put(t), put(probe), put(cd2p), put(codes_cell), put(bias_cell),
            put(cand))
    for lut in LUTS:
        tag = f"K1 cells {lut} probes outside [0, nlist)"
        err = max(err, compare_k1_cells(torch, ops, ref, tag + " cand",
                                        *args, 40, lut, None))
        err = max(err, compare_k1_cells(torch, ops, ref, tag + " fills",
                                        *args, 40, lut, None, put(fill)))
        err = max(err, compare_k1_cells(
            torch, ops, ref, tag + " fills + live", *args, 40, lut, None,
            put(fill), put(live)))
    return err


def compare_k2(torch, ops, name, tables, codes, k, lut, scale=None):
    """K2 against its plain version on the same CUDA tensors: d2 and ids
    bit-equal at every LUT type (the kernel adds the M terms from 0 in
    ascending m with __fadd_rn, the plain version's order; int8 sums are
    exact and take the scale once), and a second call bit for bit.
    Returns max |err|."""
    dk, ik = ops.pq_adc_topk(tables, codes, k, lut, scale)
    torch.cuda.synchronize()
    dp, ip = ops.pq_adc_topk_plain(tables, codes, k, lut, scale)
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), f"{name}: finite mask")
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(dk, dp), f"{name}: d2 not bit-equal (max err {err})")
    check(torch.equal(ik, ip), f"{name}: ids differ")
    d2, i2 = ops.pq_adc_topk(tables, codes, k, lut, scale)
    check(torch.equal(d2, dk) and torch.equal(i2, ik),
          f"{name}: a second call differs")
    log(f"  {name}: ok, bit-equal, repeats")
    return err


def l2_read_rate(torch):
    """The L2 read rate one torch reduction reaches on this card, in
    bytes/s: the best of an 8 MB and a 24 MB f32 tensor (each inside the
    50 MB L2) broadcast 64 times and summed, so that one kernel reads the
    tensor 64 times over, after a warm-up. A rate the card reached, so a
    time computed from it bounds the L2 traffic's least time from above."""
    best = 0.0
    for mb in (8, 24):
        x = torch.ones(mb << 18, device="cuda")
        xe = x.expand(64, -1)
        ms = cuda_ms(torch, lambda: xe.sum(), reps=50, warmup=5)
        best = max(best, xe.numel() * 4 / (ms / 1e3))
    return best


def k1_bounds(torch, tables, probe, codes_cell, cell_len, k, base):
    """Bounds of K1's two entries on one scan (Q queries, P probes), each
    the larger of its bytes at the HBM rate and its operations (M adds and
    one fma a scored candidate) at the f32 peak, counting what this data
    needs. Gathered: the codes of every slot with a finite base, the base
    of every slot, the f32 tables and scales in, (d2, slot) out. Cell-major:
    the filled rows of the distinct probed cells (codes and bias) once,
    probe, cd2p and the fills, the tables, (d2, slot) out; ``l2_bytes`` is
    what its blocks read of the cells, every probe of a cell once
    (Q * C' * (M + 4) bytes, C' the filled slots a query probes)."""
    nq, m, kc = tables.shape
    cb = codes_cell.element_size()
    row = m * cb + 4
    fin = int(torch.isfinite(base).sum())
    side = nq * m * kc * 4 + nq * 4 + nq * k * 8
    a_bytes = fin * m * cb + base.numel() * 4 + side
    a_ops = fin * (m + 2)
    used = cell_len[torch.unique(probe)]
    filled = int(cell_len[probe].sum())            # Q * C'
    b_bytes = (int(used.sum()) * row + probe.numel() * 12
               + cell_len.numel() * 8 + side)
    b_ops = filled * (m + 2)

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

    (a_ms, a_by), (b_ms, b_by) = bound(a_bytes, a_ops), bound(b_bytes, b_ops)
    return {"gathered": {"bound_ms": a_ms, "bound_by": a_by,
                         "bytes": a_bytes, "ops": a_ops, "finite_slots": fin},
            "cells": {"bound_ms": b_ms, "bound_by": b_by, "bytes": b_bytes,
                      "ops": b_ops, "distinct_cells": int(used.numel()),
                      "distinct_rows": int(used.sum()),
                      "filled_slots": filled, "l2_bytes": filled * row}}


def k1_time(torch, ops, ivfpq, tables, scale, probe, cd2p, codes_cell,
            bias_cell, cand, cell_len, k, lut="int8"):
    """One padded ivfpq scan's K1 work at its shape: the candidate gather
    (``ivfpq_scan_inputs``), K1's gathered entry on its output, the two
    together, and (where the checkout has it) K1's cell-major entry on the
    cells in place; each a call's time by CUDA events over back-to-back
    calls, the entries' kernels' device time from a profiler trace, their
    plain versions' times, their plans and bounds. Calls only functions
    every version of K1 has, beside the cell-major entry."""
    nq = probe.shape[0]
    ccodes, base = ivfpq.ivfpq_scan_inputs(probe, cand, cd2p, codes_cell,
                                           bias_cell)
    a = lambda: ops.pq_adc_gather_topk(tables, ccodes, base, k, lut, scale)
    out = {"Q": nq, "P": int(probe.shape[1]), "C": int(ccodes.shape[1]),
           "M": int(tables.shape[1]), "K": int(tables.shape[2]), "k": k,
           "lut": lut}
    out["gather_ms"] = cuda_ms(torch, lambda: ivfpq.ivfpq_scan_inputs(
        probe, cand, cd2p, codes_cell, bias_cell), reps=10)
    out["gathered_ms"] = cuda_ms(torch, a, reps=20)
    out["gathered_device_ms"] = device_ms(torch, a, reps=5,
                                          match=("adc_", "select_topk"))
    out["gather_and_gathered_ms"] = cuda_ms(torch, lambda: ops.pq_adc_gather_topk(
        tables, *ivfpq.ivfpq_scan_inputs(probe, cand, cd2p, codes_cell,
                                         bias_cell), k, lut, scale), reps=10)
    out["gathered_plain_ms"] = cuda_ms(torch, lambda: (
        ops.pq_adc_gather_topk_plain(tables, ccodes, base, k, lut, scale)),
        reps=3, warmup=1)
    if hasattr(ops, "pq_adc_cells_topk"):
        b = lambda: ops.pq_adc_cells_topk(tables, probe, cd2p, codes_cell,
                                          bias_cell, cand, k, lut, scale,
                                          cell_len)
        out["cells_ms"] = cuda_ms(torch, b, reps=20)
        out["cells_device_ms"] = device_ms(torch, b, reps=5,
                                           match=("adc_", "select_topk"))
        out["cells_plain_ms"] = cuda_ms(torch, lambda: (
            ops.pq_adc_cells_topk_plain(tables, probe, cd2p, codes_cell,
                                        bias_cell, cand, k, lut, scale)),
            reps=3, warmup=1)
        m, kc = tables.shape[1:]
        cb = codes_cell.element_size()
        out["plans"] = {
            "gathered": ops.pq_adc_select_plan(
                "gathered", nq, out["C"], 1, m, kc, k, lut, cb,
                tables.device),
            "cells": ops.pq_adc_select_plan(
                "cells", nq, out["P"], int(codes_cell.shape[1]), m, kc, k,
                lut, cb, tables.device)}
        out["bounds"] = k1_bounds(torch, tables, probe, codes_cell, cell_len,
                                  k, base)
    return out


def log_k1_time(tag, r):
    log(f"[{tag}] K1 at Q {r['Q']} P {r['P']} C {r['C']} ({r['lut']}): "
        f"gather {r['gather_ms']:.4f} ms, gathered entry "
        f"{r['gathered_ms']:.4f} ms a call ({r['gathered_device_ms']:.4f} of "
        f"its kernels), gather + gathered {r['gather_and_gathered_ms']:.4f} "
        f"ms, plain {r['gathered_plain_ms']:.4f} ms")
    if "cells_ms" in r:
        bd = r["bounds"]
        log(f"[{tag}] K1 cell-major entry {r['cells_ms']:.4f} ms a call "
            f"({r['cells_device_ms']:.4f} of its kernels), plain "
            f"{r['cells_plain_ms']:.4f} ms; bounds: gathered "
            f"{bd['gathered']['bound_ms']:.4f} ms "
            f"({bd['gathered']['bound_by']}), cell-major "
            f"{bd['cells']['bound_ms']:.4f} ms ({bd['cells']['bound_by']}; "
            f"{bd['cells']['distinct_cells']} distinct cells, L2 "
            f"{bd['cells']['l2_bytes']} B); plans "
            f"{ {n: (p['parts'], p['blocks_per_sm'], round(p['waves'], 3)) for n, p in r['plans'].items()} } "
            "(parts, blocks an SM, waves)")


def k1_alone():
    """``python3 chip_smoke.py --k1-timings``: K1 alone at path 1's shapes
    on a seeded synthetic cell layout (1,024 cells over 1,000,000 rows,
    skewed sizes; 256 queries probing 16 cells each, denser cells more
    often; M 16, K 256, k 64, uint8 codes; int8 LUT, with f32 and bf16 at
    batch 256), with ``k1_time``'s times; then the gathered entry at
    batches 1, 8 and 64 on compact-scan-like inputs (C the sum of the 16
    largest fills, rounded up to 128). It calls nothing of the port but
    ``ivfpq_scan_inputs``, the K1 wrappers and their plain versions, so a
    copy of this script at the root of another checkout times that
    checkout's K1 on the same inputs. Prints the card's line and one JSON
    line {"k1_alone": {...}}; exits nonzero without a card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.search import ivfpq
    smi = card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    nlist, nprobe, m, kc = 1024, 16, 16, 256
    w = rng.gamma(2.0, size=nlist)
    sizes = rng.multinomial(N, w / w.sum())
    lists, codes_cell, bias_cell, fill = cell_index(rng, nlist, sizes, m, kc)
    probe, cd2p, cand = cell_probe(rng, 256, sizes, nprobe, lists, RERANK)
    tables = torch.from_numpy((rng.uniform(size=(256, m, kc)) * 5).astype(
        np.float32)).to(dev)

    def put(a):
        return torch.from_numpy(a).to(dev)

    cells = (put(probe), put(cd2p), put(codes_cell), put(bias_cell),
             put(cand), put(fill))
    out = {"card": smi, "max_cell": int(lists.shape[1])}
    for lut in LUTS:
        r = k1_time(torch, ops, ivfpq, tables, None, *cells, RERANK, lut)
        out[f"{lut} Q=256"] = r
        log_k1_time(f"k1 alone {lut}", r)
    cap = -(-int(np.sort(sizes)[-nprobe:].sum()) // 128) * 128
    codes = put(rng.integers(0, kc, (64, cap, m)).astype(np.uint8))
    base = put(rng.uniform(size=(64, cap)).astype(np.float32))
    for b in (1, 8, 64):
        fn = lambda: ops.pq_adc_gather_topk(tables[:b], codes[:b], base[:b],
                                            RERANK, "int8")
        r = {"C": cap, "ms": cuda_ms(torch, fn, reps=20),
             "device_ms": device_ms(torch, fn, reps=5,
                                    match=("adc_", "select_topk"))}
        out[f"int8 compact Q={b}"] = r
        log(f"[k1 alone] gathered entry int8 Q={b} C={cap}: {r['ms']:.4f} ms "
            f"a call, {r['device_ms']:.4f} ms of its kernels")
    print(json.dumps({"k1_alone": out}))
    return 0


def k4_time(torch, pw, fast_objective, p, k_pairs):
    """K4 at the fit's N on one step's projections: the entry at a given
    tau (device time of its kernels from a profiler trace, a call by CUDA
    events back to back), the fit's threshold bisection alone, the two-step
    route of a step's statistics (the bisection, then that entry) as a
    synchronized call on the host's clock, and (where the checkout has it)
    the fused entry the same ways with K4's empty kernel (the launch
    floor); each with its plain version and bound."""
    tau = fast_objective.find_quantile_threshold(p, k_pairs)
    n = p.shape[0]
    out = {"N": n, "k_pairs": k_pairs}

    def host_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out["unfused_device_ms"] = device_ms(
        torch, lambda: pw.pairwise_stats(p, tau), reps=200, match="pair_")
    out["unfused_ms"] = cuda_ms(torch, lambda: pw.pairwise_stats(p, tau),
                                reps=200)
    out["unfused_plain_ms"] = cuda_ms(
        torch, lambda: pw.pairwise_stats_ref(p, tau), reps=20)
    out["threshold_ms"] = host_ms(
        lambda: fast_objective.find_quantile_threshold(p, k_pairs))
    out["unfused_route_host_ms"] = host_ms(lambda: pw.pairwise_stats(
        p, fast_objective.find_quantile_threshold(p, k_pairs)))
    nb = n * 4 + 4 + n * 4 + 8 + 4              # p, tau in; coeff, count, sum
    nops = 5 * n * (n - 1)                       # sub, abs, compare, 2 adds
    out["unfused_bound_ms"] = max(nb / HBM_BYTES_PER_S,
                                  nops / F32_OPS_PER_S) * 1e3
    if hasattr(pw, "pairwise_stats_at_quantile"):
        fused = lambda: pw.pairwise_stats_at_quantile(p, k_pairs)
        out["fused_device_ms"] = device_ms(torch, fused, reps=200,
                                           match="quantile_stats")
        out["fused_ms"] = cuda_ms(torch, fused, reps=200)
        out["fused_host_ms"] = host_ms(fused)
        out["fused_plain_ms"] = cuda_ms(
            torch, lambda: pw.pairwise_stats_at_quantile_ref(p, k_pairs),
            reps=5, warmup=1)
        out["floor_ms"] = cuda_ms(torch, pw.launch_floor, reps=1000,
                                  warmup=10)
        out["floor_device_ms"] = device_ms(torch, pw.launch_floor, reps=200,
                                           match="empty_kernel")
        lg = max(1, (n - 1).bit_length())
        p2 = 1 << lg
        fops = (5 * (p2 // 2) * lg * (lg + 1) // 2     # the sort's exchanges
                + 60 * n * (lg + 1) * 4                # the bisection
                + 4 * n * (lg + 1) * 4 + 8 * n)        # windows and scan
        out["fused_ops"] = fops
        out["fused_bound_ms"] = max(nb / HBM_BYTES_PER_S,
                                    fops / F32_OPS_PER_S) * 1e3
        out["fused_bound_by"] = ("bytes" if nb / HBM_BYTES_PER_S >=
                                 fops / F32_OPS_PER_S else "operations")
    return out


def log_k4_time(tag, r):
    log(f"[{tag}] K4 at N {r['N']}: at a given tau {r['unfused_device_ms']:.4f}"
        f" ms of its kernels ({r['unfused_ms']:.4f} ms a call back to back), "
        f"plain {r['unfused_plain_ms']:.4f} ms, bound "
        f"{r['unfused_bound_ms']:.6f} ms; the bisection alone "
        f"{r['threshold_ms']:.4f} ms, bisection + K4 "
        f"{r['unfused_route_host_ms']:.4f} ms (synchronized, host clock)")
    if "fused_ms" in r:
        log(f"[{tag}] K4 fused {r['fused_device_ms']:.4f} ms of its kernel, "
            f"{r['fused_ms']:.4f} ms a call back to back, "
            f"{r['fused_host_ms']:.4f} ms synchronized; plain "
            f"{r['fused_plain_ms']:.4f} ms; bound {r['fused_bound_ms']:.6f} "
            f"ms ({r['fused_ops']} ops); launch floor {r['floor_ms']:.4f} ms "
            f"a launch back to back, {r['floor_device_ms']:.6f} ms on the "
            "card")


def step_launches(torch, mpad_mod, phi_vg, xs, w0):
    """Kernel launches a fit step makes (the objective, Adam, the
    normalization and the trace write), from profiler traces of
    greedy_fit_loop at 1 direction of 2 and of 6 steps: the difference
    over 4."""
    counts = []
    for iters in (2, 6):
        loop = lambda: mpad_mod.greedy_fit_loop(
            xs, w0[:1], phi_vg, m=1, b=FIT["b"], alpha=FIT["alpha"],
            iters=iters, lr=0.05, batch_size=None, beta1=0.9, beta2=0.999,
            adam_eps=1e-8)
        kern, _ = kernel_trace(torch, loop, 1, f"fit loop of {iters} steps")
        counts.append(sum(e.count for e in kern))
    return (counts[1] - counts[0]) / 4


def fit_run(torch, mpad_mod, phi_vg, xs, w0, m=FIT["m"]):
    """A fit of ``m`` directions (path 2's: FIT's b, alpha and iters) by
    greedy_fit_loop on ``xs`` from the start directions ``w0``, timed on
    the host's clock, synchronized. Returns (directions, traces,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dirs, traces = mpad_mod.greedy_fit_loop(
        xs, w0[:m], phi_vg, m=m, b=FIT["b"], alpha=FIT["alpha"],
        iters=FIT["iters"], lr=0.05, batch_size=None, beta1=0.9, beta2=0.999,
        adam_eps=1e-8)
    torch.cuda.synchronize()
    return dirs, traces, time.perf_counter() - t0


def k4_alone():
    """``python3 chip_smoke.py --k4-timings``: K4 alone at the fit's N on a
    seeded sample (clustered_corpus(FIT_SAMPLE, DIM, SEED + 3), centred;
    one step's projections on a seeded unit w), with ``k4_time``'s times;
    then path 2's whole fit (m 64 x 48 steps) on the kernel backend from
    seeded start directions, timed, with its launches a step and the
    SHA-1 of its directions' bytes (equal digests: bit-equal directions,
    across checkouts). It calls only functions every version of K4
    has, beside the fused entry, so a copy of this script at the
    root of another checkout times that checkout's K4 on the same inputs.
    Prints the card's line and one JSON line {"k4_alone": {...}}; exits
    nonzero without a card."""
    import hashlib

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import fast_objective
    from repro_torch.core import mpad as mpad_mod
    from repro_torch.core.objective import num_selected_pairs
    from repro_torch.kernels import mpad_pairwise as pw
    smi = card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(clustered_corpus(FIT_SAMPLE, DIM, SEED + 3)).to(dev)
    xs = x - x.mean(dim=0)
    w = torch.from_numpy(rng.standard_normal(DIM).astype(np.float32)).to(dev)
    p = xs @ (w / w.norm())
    k_pairs = num_selected_pairs(FIT_SAMPLE, FIT["b"])
    r = k4_time(torch, pw, fast_objective, p, k_pairs)
    log_k4_time("k4 alone", r)
    w0 = torch.from_numpy(rng.standard_normal((FIT["m"], DIM)).astype(
        np.float32)).to(dev)
    r["launches_per_step"] = step_launches(
        torch, mpad_mod, pw.phi_kernel_value_and_grad, xs, w0)
    dirs, _, secs = fit_run(torch, mpad_mod, pw.phi_kernel_value_and_grad,
                            xs, w0)
    r["fit_s"] = secs
    r["fit_steps"] = FIT["m"] * FIT["iters"]
    r["directions_sha1"] = hashlib.sha1(
        dirs.cpu().numpy().tobytes()).hexdigest()
    log(f"[k4 alone] a fit step launches {r['launches_per_step']:.1f} "
        f"kernels; the fit ({r['fit_steps']} steps) {secs:.3f} s, directions "
        f"sha1 {r['directions_sha1']}")
    print(json.dumps({"k4_alone": dict(r, card=smi)}))
    return 0


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def k2_bound(nq, n, m, kc, k):
    """The least time of one K2 call: the larger of its bytes (the uint8
    codes, the f32 tables it is handed and the (d2, row) pairs out, each
    once) at the HBM rate and its operations (M adds and one rescale a
    (query, row)) at the f32 peak. Returns (ms, by)."""
    nbytes = n * m + nq * m * kc * 4 + nq * k * 8
    nops = nq * n * (m + 1)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


K2_RUNS = (("int8", BATCHES), ("bf16", (256,)), ("f32", (256,)))


def k2_time_one(torch, ops, t, codes, lut):
    """One K2 shape: the call's time by CUDA events over back-to-back
    calls (``ms``; at small batches the host's launches dominate it), the
    median of 100 single calls each synchronized, on the host's clock
    (``host_ms``: what one call costs a caller that waits for it), the
    device time of K2's own kernels from a profiler trace (the scan and
    the merge), the plain version's time and the bound."""
    b, m, kc = t.shape
    ms = cuda_ms(torch, lambda: ops.pq_adc_topk(t, codes, RERANK, lut),
                 reps=10)
    one = []
    for _ in range(100):
        t0 = time.perf_counter()
        ops.pq_adc_topk(t, codes, RERANK, lut)
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_ms(torch, lambda: ops.pq_adc_topk(t, codes, RERANK,
                                                      lut), reps=5,
                       match=("adc_shared_select", "select_topk"))
    plain_ms = cuda_ms(torch, lambda: ops.pq_adc_topk_plain(
        t, codes, RERANK, lut), reps=3, warmup=1)
    bound, by = k2_bound(b, codes.shape[0], m, kc, RERANK)
    return {"ms": ms, "host_ms": float(np.median(one)), "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def k2_timings(torch, ops, tables, codes):
    """K2 on path 2's own tables and codes: int8 at every batch of
    BATCHES, f32 and bf16 at 256 (``k2_time_one``), with the plan the
    kernel launched (queries a block, occupancy, blocks, waves)."""
    kc = tables["int8"].shape[2]
    out = {}
    for lut, batches in K2_RUNS:
        for b in batches:
            t = tables[lut][:b]
            run = k2_time_one(torch, ops, t, codes, lut)
            plan = ops.pq_adc_topk_plan(codes, b, kc, RERANK, lut)
            out[f"{lut} Q={b}"] = dict(run, plan=plan)
            log(f"[timings] K2 {lut} Q={b}: {run['ms']:.4f} ms a call, "
                f"{run['host_ms']:.4f} ms a synchronized call, "
                f"{run['device_ms']:.4f} ms of its kernels, plain "
                f"{run['plain_ms']:.4f} ms, bound {run['bound_ms']:.4f} ms "
                f"({run['bound_by']}); plan QB {plan['qb']} "
                f"({plan['entry']} entries, {plan['smem']} B shared a "
                f"block), {plan['parts']} row parts, "
                f"{plan['blocks_per_sm']} blocks an SM (occupancy) x "
                f"{plan['sms']} SMs, {plan['blocks']} blocks = "
                f"{plan['waves']:.3f} waves")
    return out


def k2_alone():
    """``python3 chip_smoke.py --k2-timings``: K2 alone at path 2's shapes
    (N 1,000,000, M 16, K 256, k 64, uint8 codes) on codes and positive
    tables drawn from a seed, at K2_RUNS, each with ``k2_time_one``'s
    times, then at the pq cell's shape (``k2_cell_time``: Q 1,024 over
    5M rows). It calls nothing of the port but ``pq_adc_topk`` and
    ``pq_adc_topk_plain``, whose signatures every version of K2 shares,
    so a copy of this script at the root of another checkout times that
    checkout's K2 on the same inputs. Prints the card's line and one JSON
    line {"k2_alone": {...}}; exits nonzero without a card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.pq_adc import ops
    smi = card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    codes = torch.from_numpy(rng.integers(0, 256, (N, 16)).astype(
        np.uint8)).to(dev)
    tables = torch.from_numpy((rng.uniform(size=(256, 16, 256)) * 5).astype(
        np.float32)).to(dev)
    out = {"card": smi}
    for lut, batches in K2_RUNS:
        for b in batches:
            run = k2_time_one(torch, ops, tables[:b], codes, lut)
            out[f"{lut} Q={b}"] = run
            log(f"[k2 alone] {lut} Q={b}: {run['ms']:.4f} ms a call, "
                f"{run['host_ms']:.4f} ms a synchronized call, "
                f"{run['device_ms']:.4f} ms of its kernels, plain "
                f"{run['plain_ms']:.4f} ms, bound {run['bound_ms']:.4f} ms")
    del codes, tables
    out[K2_CELL_LABEL] = k2_cell_time(torch, ops, rng, dev)
    print(json.dumps({"k2_alone": out}))
    return 0


# the benchmark's exhaustive pq cell: a batch of 1,024 int8 queries over
# 5M rows of 16 uint8 codes (K 256), k 64 (bench/configs/openai1536-5m-pq)
K2_CELL = (1024, 5_000_000, 16, 256)
K2_CELL_LABEL = "int8 Q=1024 N=5000000"
K2_CELL_CHECK = 64             # queries held against the plain version


def k2_cell_time(torch, ops, rng, dev):
    """K2 alone at the pq cell's shape (``K2_CELL``) on codes and positive
    tables drawn from ``rng``: ``k2_time_one``'s times but the plain
    version's (its (Q, N) scores would take ~20 GB), and the first
    ``K2_CELL_CHECK`` queries' d2 and ids held bit for bit against the
    plain version on those queries alone (an int8 query's scale is its
    own, so its answer does not depend on the rest of the batch)."""
    nq, n, m, kc = K2_CELL
    codes = torch.from_numpy(rng.integers(0, kc, (n, m)).astype(
        np.uint8)).to(dev)
    t = torch.from_numpy((rng.uniform(size=(nq, m, kc)) * 5).astype(
        np.float32)).to(dev)
    d, i = ops.pq_adc_topk(t, codes, RERANK, "int8")
    torch.cuda.synchronize()
    dr, ir = ops.pq_adc_topk_plain(t[:K2_CELL_CHECK], codes, RERANK, "int8")
    check(torch.equal(d[:K2_CELL_CHECK], dr) and
          torch.equal(i[:K2_CELL_CHECK], ir),
          "K2 at the pq cell's shape differs from its plain version")
    del d, i, dr, ir
    ms = cuda_ms(torch, lambda: ops.pq_adc_topk(t, codes, RERANK, "int8"),
                 reps=10)
    dev_ms = device_ms(torch, lambda: ops.pq_adc_topk(t, codes, RERANK,
                                                      "int8"), reps=5,
                       match=("adc_shared_select", "select_topk"))
    bound, by = k2_bound(nq, n, m, kc, RERANK)
    plan = ops.pq_adc_topk_plan(codes, nq, kc, RERANK, "int8") \
        if hasattr(ops, "pq_adc_topk_plan") else None
    run = {"ms": ms, "device_ms": dev_ms, "bound_ms": bound,
           "bound_by": by, "checked_queries": K2_CELL_CHECK, "plan": plan}
    log(f"[k2 alone] {K2_CELL_LABEL}: {ms:.4f} ms a call, {dev_ms:.4f} ms "
        f"of its kernels, bound {bound:.4f} ms ({by}); plan {plan}")
    return run


def edge_cases_k2(torch, ops):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    err = 0.0

    def put(a):
        return torch.from_numpy(a).to(dev)

    for lut in LUTS:
        for (nq, n, m, kc, k) in ((9, 5003, 16, 256, 12),    # ragged N
                                  (5, 40, 16, 256, 64),      # k > N
                                  (1, 100_000, 16, 256, 64),  # Q = 1
                                  (3, 50_000, 16, 256, 1),   # QB 4, k = 1
                                  (13, 3000, 8, 64, 20),     # byte loads
                                  (4, 20_000, 16, 256, 1000),  # large k
                                  (9, 5003, 6, 256, 5006),   # k = N + 3
                                  (16, N, 16, 256, 64)):     # N = 1M
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (n, m)).astype(np.uint8)
            err = max(err, compare_k2(torch, ops,
                                      f"K2 edge {lut} Q={nq} N={n} M={m} "
                                      f"k={k}", put(t), put(codes), k, lut))
    # exact int8 ties: integer tables, caller scale 1
    t = rng.integers(-3, 4, (6, 4, 8)).astype(np.float32)
    codes = rng.integers(0, 8, (3000, 4)).astype(np.uint8)
    dp, _ = ops.pq_adc_topk_plain(put(t), put(codes), 50, "int8",
                                  torch.ones(6, device=dev))
    check(int((dp[:, 1:] == dp[:, :-1]).sum()) > 50, "K2 ties are not real")
    compare_k2(torch, ops, "K2 edge int8 exact ties", put(t), put(codes),
               50, "int8", torch.ones(6, device=dev))
    # int8 entries of +-127 past 256 subspaces: the 16-bit lanes flushed
    # into int32 mid-row
    t = rng.choice([-1.0, 1.0], size=(5, 300, 4)).astype(np.float32)
    codes = rng.integers(0, 4, (3000, 300)).astype(np.uint8)
    compare_k2(torch, ops, "K2 edge int8 M=300 lane flush", put(t),
               put(codes), 10, "int8")
    # int32 codes (K > 256): ragged N, k = 1 and k = N, M 8 and M 6
    for lut in LUTS:
        for (nq, n, m, kc, k) in ((9, 5003, 8, 512, 1), (5, 20_001, 8, 1024, 64),
                                  (3, 700, 6, 1024, 700)):
            t = (rng.uniform(size=(nq, m, kc)) * 5).astype(np.float32)
            codes = rng.integers(0, kc, (n, m)).astype(np.int32)
            err = max(err, compare_k2(torch, ops,
                                      f"K2 edge int32 {lut} Q={nq} N={n} "
                                      f"M={m} K={kc} k={k}", put(t),
                                      put(codes), k, lut))
    return err


def compare_k4(torch, pw, name, p, tau):
    """K4 against its plain version: count and coeff equal (exact
    integers), sum within 1e-5 relative (the kernel adds in another order
    than torch.sum). Returns max |err| over sum and coeff."""
    ck, sk, fk = pw.pairwise_stats(p, tau)
    torch.cuda.synchronize()
    cp, sp, fp = pw.pairwise_stats_ref(p, tau)
    check(int(ck) == int(cp), f"{name}: count {int(ck)} != {int(cp)}")
    check(torch.equal(fk, fp), f"{name}: coeff differs")
    err = abs(float(sk) - float(sp))
    check(err <= 1e-5 * abs(float(sp)), f"{name}: sum {float(sk)} vs "
          f"{float(sp)}")
    log(f"  {name}: ok, count {int(ck)}, |sum err| {err:.3e}")
    return err


def compare_k4_fused(torch, pw, fast_objective, name, p, k_pairs):
    """K4's fused entry against the fit's two steps on the same CUDA
    tensor: tau bit-equal to ``find_quantile_threshold``'s, count and coeff
    equal to ``pairwise_stats_ref``'s at it, the sum within 1e-5 relative,
    and a second call bit for bit. Returns |sum err|."""
    tau, ck, sk, fk = pw.pairwise_stats_at_quantile(p, k_pairs)
    torch.cuda.synchronize()
    want = fast_objective.find_quantile_threshold(p, k_pairs)
    check(torch.equal(tau.view(torch.int32), want.view(torch.int32)),
          f"{name}: tau {float(tau)!r} != {float(want)!r}")
    cp, sp, fp = pw.pairwise_stats_ref(p, want)
    check(int(ck) == int(cp), f"{name}: count {int(ck)} != {int(cp)}")
    check(torch.equal(fk, fp), f"{name}: coeff differs")
    err = abs(float(sk) - float(sp))
    check(err <= 1e-5 * abs(float(sp)), f"{name}: sum {float(sk)} vs "
          f"{float(sp)}")
    again = pw.pairwise_stats_at_quantile(p, k_pairs)
    check(all(torch.equal(a, b) for a, b in zip(again, (tau, ck, sk, fk))),
          f"{name}: a second call differs")
    log(f"  {name}: ok, tau bit-equal, count {int(ck)}, |sum err| "
        f"{err:.3e}, repeats")
    return err


def edge_cases_k4(torch, pw, fast_objective, num_selected_pairs):
    """K4 at a given tau (N 1, 2, ragged, 2048, 2500, 20,000, repeated
    values; tau 0, 0.5, +inf), then the fused entry at the same N (20,000
    takes the global-scratch route) with k_pairs 1, the fit's b = 80 and
    all pairs."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    err = 0.0
    for n in (1, 2, 1000, 2048, 2500, 20_000):
        for repeated in (False, True):
            p = (rng.integers(0, 20, n).astype(np.float32) if repeated
                 else rng.standard_normal(n).astype(np.float32))
            pd = torch.from_numpy(p).to(dev)
            for tau in (0.0, 0.5, float("inf")):
                err = max(err, compare_k4(
                    torch, pw, f"K4 edge N={n} repeated={repeated} "
                    f"tau={tau}", pd, torch.tensor(tau, device=dev)))
            for kp in sorted({1, num_selected_pairs(n, FIT["b"]),
                              n * (n - 1) // 2}):
                err = max(err, compare_k4_fused(
                    torch, pw, fast_objective, f"K4 fused edge N={n} "
                    f"repeated={repeated} k_pairs={kp}", pd, kp))
    return err


def k3_plain(torch, kt, q, x, k, chunk=1 << 28):
    """K3's plain version on the card, over query chunks of at most
    ``chunk`` distances each (the full (Q, N) matrix of the path's shapes
    does not fit): each query's row is independent, so the result is the
    plain version's."""
    rows = max(1, chunk // max(1, x.shape[0]))
    outs = [kt.knn_topk_plain(q[i:i + rows], x, k)
            for i in range(0, q.shape[0], rows)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def k3_tolerance(torch, q, x):
    """d2 tolerance per query: 4e-6 of |q|^2 + max |x|^2, the magnitude of
    the summands. K3 and its plain version compute the same f32 products
    and norms and add them in other orders (FMAs over 16-dim chunks against
    torch's matmul and reductions); each d2 is rounded from sums of that
    magnitude, so the two differ by a few of its ulps (about 1e-5 absolute
    for unit-norm rows, where d2 itself is at most 4)."""
    qf, xf = q.float(), x.float()
    qq = (qf * qf).sum(dim=1)
    xmax = float((xf * xf).sum(dim=1).max()) if x.shape[0] else 0.0
    return 4e-6 * (qq + xmax)                     # (Q,)


def compare_k3(torch, kt, name, q, x, k, exact=False):
    """K3 against its plain version on the same CUDA tensors. ``exact``
    (small-integer data, every product and sum exact in f32): d2 and ids
    bit-equal, ties included. Else: finite masks and unfilled slots equal,
    d2 within ``k3_tolerance``, every id the kernel returns has that d2 in
    the plain formula (within the tolerance), and the ids equal wherever the
    plain d2 lies more than the tolerance below the k-th (the rest are
    near-ties that either order may keep). Returns max |d2 err|."""
    dk, ik = kt.knn_topk_d2(q, x, k)
    torch.cuda.synchronize()
    dp, ip = k3_plain(torch, kt, q, x, k)
    check(dk.shape == dp.shape and ik.dtype == torch.int64,
          f"{name}: shape {tuple(dk.shape)} {ik.dtype}")
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), f"{name}: finite mask")
    check(torch.equal(ik[~fin], ip[~fin]), f"{name}: unfilled slots")
    err = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    if exact:
        check(torch.equal(dk, dp), f"{name}: d2 not bit-equal (max err {err})")
        check(torch.equal(ik, ip), f"{name}: ids differ")
        log(f"  {name}: ok, bit-equal")
        return err
    tol = k3_tolerance(torch, q, x)[:, None].expand_as(dp)
    check(bool(((dk - dp).abs()[fin] <= tol[fin]).all()),
          f"{name}: d2 beyond the tolerance (max err {err})")
    qf, xf = q.float(), x.float()
    own = torch.zeros_like(dk)
    for i in range(0, q.shape[0], 4096):        # the kernel's ids, re-scored
        g = xf[ik[i:i + 4096].clamp_min(0)]        # (rows, k, D)
        qi = qf[i:i + 4096]
        own[i:i + 4096] = ((qi * qi).sum(1)[:, None] + (g * g).sum(2)
                           - 2.0 * (g @ qi[:, :, None])[..., 0]).clamp_min(0.0)
    check(bool(((own - dk).abs()[fin] <= tol[fin]).all()),
          f"{name}: an id does not have its distance")
    kth = torch.where(fin, dp, -float("inf")).amax(dim=1, keepdim=True)
    clear = fin & (dp < kth - tol)
    present = torch.cat([(ip[i:i + 65536, :, None]
                          == ik[i:i + 65536, None, :]).any(dim=2)
                         for i in range(0, q.shape[0], 65536)])
    check(bool((present | ~clear).all()), f"{name}: a neighbour well inside "
          "the k-th distance is missing")
    same = float((ik == ip).float().mean())
    log(f"  {name}: ok, max |d2 err| {err:.3e}, ids equal on {same:.6f} "
        "of slots")
    return err


def edge_cases_k3(torch, kt):
    """K3 against its plain version on edge cases: Q = 1 and ragged Q; N = 1,
    N under one tile, ragged N; k = 1, k = N, k > N, k 512, 513 and 4096 (the
    lists in shared memory, then in global scratch), k = N + 3; D = 1, 19,
    38, 64, 384; duplicate rows and queries; small-integer data (bit-equal);
    bf16 inputs; N = 1,000,000 at D = 384; Q = 1,000,000 against N = 2048;
    and a repeat of one call, bit for bit."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    err = 0.0

    def unit(n, d):
        a = rng.standard_normal((n, d), dtype=np.float32)
        a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        return torch.from_numpy(a).to(dev)

    for (nq, n, d, k) in ((1, 5003, 38, 10), (100, 5003, 19, 15),
                          (130, 1, 64, 1), (7, 50, 384, 50), (9, 50, 38, 64),
                          (65, 777, 1, 5), (3, 20_000, 64, 512),
                          (33, 4099, 384, 64), (257, 3000, 38, 200),
                          (40, 20_000, 64, 513), (5, 20_000, 38, 4096),
                          (17, 700, 19, 703)):
        err = max(err, compare_k3(torch, kt, f"K3 edge f32 Q={nq} N={n} "
                                  f"D={d} k={k}", unit(nq, d), unit(n, d), k))
    # duplicate database rows and duplicate queries (exact ties in d2)
    x = unit(600, 38)
    x = torch.cat([x, x[:300], x[::7]])
    q = unit(40, 38)
    q = torch.cat([q, q[:10], x[:5]])
    err = max(err, compare_k3(torch, kt, "K3 edge duplicates", q, x, 20))
    # small integers: every product and sum exact, ties everywhere
    for (nq, n, d, k) in ((70, 3001, 19, 40), (5, 70_000, 38, 64),
                          (64, 128, 1, 128), (130, 5000, 384, 15),
                          (20, 9000, 64, 1500)):
        qi = torch.from_numpy(rng.integers(-3, 4, (nq, d)).astype(
            np.float32)).to(dev)
        xi = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(
            np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            compare_k3(torch, kt, f"K3 edge integers {dt} Q={nq} N={n} "
                       f"D={d} k={k}", qi.to(dt), xi.to(dt), k, exact=True)
    # bf16 inputs on float data
    err = max(err, compare_k3(torch, kt, "K3 edge bf16 Q=77 N=9000 D=384",
                              unit(77, 384).bfloat16(),
                              unit(9000, 384).bfloat16(), 15))
    # the path's extremes: N = 1,000,000 at D = 384; Q = 1,000,000 vs 2048
    big = unit(1_000_000, 384)
    err = max(err, compare_k3(torch, kt, "K3 edge Q=64 N=1M D=384",
                              unit(64, 384), big, 15))
    err = max(err, compare_k3(torch, kt, "K3 edge Q=1M N=2048 D=384", big,
                              unit(2048, 384), 10))
    # a call repeats bit for bit (no float atomics)
    q, x = unit(300, 38), big[:200_000, :38].contiguous()
    a, b = kt.knn_topk_d2(q, x, 15), kt.knn_topk_d2(q, x, 15)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "K3 does not repeat bit for bit")
    log("  K3 edge repeat: ok, bit for bit")
    return err


def k3_bound(nq, n, d, k, elem_bytes=4):
    """The least time of one K3 call: the larger of its operations (a
    multiply-add per dim per (query, row) pair, 2 Q N D, at the f32 rate
    outside the tensor cores: the kernel must not round products as TF32
    or bf16) and its bytes (q and x read once, (d2, idx) written once) at
    the HBM rate. Returns (ms, by, ops, bytes)."""
    nops = 2 * nq * n * d
    nbytes = (nq + n) * d * elem_bytes + nq * k * 8
    t_ops, t_bytes = nops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nops, nbytes)


def k3_timing(torch, kt, name, q, x, k, reps=3, library=False):
    """K3, its plain version and the bound at one of the path's shapes
    (with the two-call topk(cdist) yardstick where its (Q, N) fits)."""
    ms = cuda_ms(torch, lambda: kt.knn_topk_d2(q, x, k), reps=reps, warmup=1)
    plain = cuda_ms(torch, lambda: k3_plain(torch, kt, q, x, k), reps=1,
                    warmup=1)
    bound, by, nops, nbytes = k3_bound(q.shape[0], x.shape[0], q.shape[1], k)
    out = {"Q": q.shape[0], "N": x.shape[0], "D": q.shape[1], "k": k,
           "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
           "ops": nops, "bytes": nbytes, "tflops": nops / ms / 1e9,
           "library_ms": None}
    if library:
        out["library_ms"] = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, x), k, largest=False), reps=reps, warmup=1)
    log(f"[timings] K3 {name} (Q {q.shape[0]}, N {x.shape[0]}, D "
        f"{q.shape[1]}, k {k}): {ms:.3f} ms ({out['tflops']:.1f} TFLOP/s), "
        f"plain {plain:.3f} ms, bound {bound:.3f} ms ({by}), topk(cdist) "
        f"{out['library_ms']}")
    return out


def eval_path(torch, mods, xd, counters):
    """Path 5: the paper's evaluation path on the 1M x 384 corpus. Test
    queries from the corpus's distribution, a 2048-row fit sample, m = 38
    (ratio 0.1), the MPAD fit and the six baselines, A_m(k) over the whole
    corpus for every k of K_VALUES (K3 at least twice a call); then the
    pca64>rr64 flat engine (K3 scans) and the mlp64 ivfpq engine (K1), the
    exact fit backend against the fast one, K3 on the path's own inputs
    and its timings. Returns (result dict, K3 launches on the main run,
    K3's max |err| on the path's inputs, the kernels-line timing)."""
    (kt, knn, MPADConfig, fit_mpad, fast_objective, objective, mpad_mod,
     baselines, paper, cpu_generator, build_engine, reduce_vectors,
     exact_rerank, recall_at_k, kops, SearchEngine) = mods
    dev = xd.device
    out = {"queries": EVAL_Q, "fit_sample": FIT_SAMPLE}
    m = int(paper.TARGET_RATIOS[1] * DIM)               # 38
    out["m"] = m
    qd = torch.from_numpy(clustered_corpus(EVAL_Q, DIM, SEED + 2)).to(dev)
    rows = torch.randperm(N, generator=cpu_generator(SEED))[:FIT_SAMPLE]
    sample = xd[rows.to(dev)].contiguous()

    # the fits, timed (host clock, synchronized)
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, time.perf_counter() - t0

    for fn in counters:
        fn.launches = 0
    reducers, fit_s = {}, {}
    reducers["mpad"], fit_s["mpad"] = timed(lambda: fit_mpad(
        sample, MPADConfig(m=m, b=80.0, alpha=25.0, iters=48), device=dev))
    for name, fit in baselines.BASELINE_FITTERS.items():
        reducers[name], fit_s[name] = timed(
            lambda: fit(sample, m, cpu_generator(SEED)))
    fit_launches = kt.knn_topk_d2.launches
    out["fit_s"] = fit_s
    log(f"[path 5] fits on {FIT_SAMPLE} rows to m = {m} (s): "
        f"{ {k: round(v, 2) for k, v in fit_s.items()} }; K3 launches in "
        f"the fits: {fit_launches}")
    check(fit_launches == 0, "K3 ran in a fit (the fits' neighbour sets "
          "are plain)")
    transform_s = {}
    for name, red in reducers.items():
        y, transform_s[name] = timed(lambda: red(xd))
        check(tuple(y.shape) == (N, m) and bool(torch.isfinite(y).all()),
              f"{name}: bad transform of the corpus")
        del y
    out["transform_1m_s"] = transform_s
    # F2: UMAP's fit again from the same draws, its map of the test queries
    # bit for bit (its updates are fixed-order segment sums)
    umap2, out["umap_refit_s"] = timed(
        lambda: baselines.BASELINE_FITTERS["umap"](sample, m,
                                                   cpu_generator(SEED)))
    check(torch.equal(umap2(qd), reducers["umap"](qd)),
          "UMAP's fit does not repeat bit for bit")
    log(f"[path 5] UMAP refit: the same map of the queries, bit for bit "
        f"({out['umap_refit_s']:.2f} s)")
    del umap2
    log(f"[path 5] transforms of the {N} rows (s): "
        f"{ {k: round(v, 3) for k, v in transform_s.items()} }")

    # the main run: A_m(k) for every method and k, counts zeroed just
    # before and read just after
    for fn in counters:
        fn.launches = 0
    amk, amk_s, amk_launches = {}, {}, {}
    for k in paper.K_VALUES:
        for name, red in reducers.items():
            n0 = kt.knn_topk_d2.launches
            acc, amk_s[f"{name}@{k}"] = timed(
                lambda: knn.amk_accuracy(red, xd, qd, k))
            got = kt.knn_topk_d2.launches - n0
            amk.setdefault(name, {})[k] = acc
            amk_launches[f"{name}@{k}"] = got
            check(got >= 2, f"A_m({k}) of {name} launched K3 {got} times")
            check(0.0 <= acc <= 1.0, f"A_m({k}) of {name} = {acc}")
    launches = kt.knn_topk_d2.launches
    others = {fn.__name__: fn.launches for fn in counters
              if fn is not kt.knn_topk_d2}
    check(not any(others.values()), f"another kernel ran in path 5 {others}")
    out["amk"] = amk
    out["amk_mean_over_k"] = {n: float(np.mean(list(v.values())))
                              for n, v in amk.items()}
    out["amk_s"] = amk_s
    out["k3_launches_per_amk"] = amk_launches
    out["k3_launches"] = launches
    log(f"[path 5] Fig. 1 row (A_m(k), {EVAL_Q} queries, N {N}, D {DIM} -> "
        f"{m}); K3 launches {launches}")
    log("  method  " + " ".join(f"k={k:<5d}" for k in paper.K_VALUES)
        + " mean")
    for name in reducers:
        log(f"  {name:7s} " + " ".join(f"{amk[name][k]:.4f} "
                                      for k in paper.K_VALUES)
            + f"{out['amk_mean_over_k'][name]:.4f}")
    log(f"[path 5] amk_accuracy s per call: "
        f"{ {k: round(v, 3) for k, v in amk_s.items()} }")

    # mpad and pca A_m(10) against the same reduced vectors run through
    # K3's plain version on the card
    truth10 = k3_plain(torch, kt, qd, xd, 10)[1]
    ref = {}
    for name in ("mpad", "pca"):
        red = reducers[name]
        found = k3_plain(torch, kt, red(qd).contiguous(),
                         red(xd).contiguous(), 10)[1]
        ref[name] = recall_at_k(found, truth10)
        check(abs(ref[name] - amk[name][10]) <= AMK_TOL,
              f"{name} A_m(10) {amk[name][10]} vs the plain version's "
              f"{ref[name]}")
    out["amk10_plain"] = ref
    log(f"[path 5] A_m(10) through K3's plain version: {ref} (K3: "
        f"{ {n: amk[n][10] for n in ref} }, tolerance {AMK_TOL})")

    # K3 on the path's own inputs, then its timings at the path's shapes
    log("[K3 main]")
    mp = reducers["mpad"]
    xr, qr = mp(xd).contiguous(), mp(qd).contiguous()
    err = 0.0
    err = max(err, compare_k3(torch, kt, "K3 main truth", qd, xd, 15))
    err = max(err, compare_k3(torch, kt, "K3 main reduced", qr, xr, 15))
    err = max(err, compare_k3(torch, kt, "K3 main transform", xd, sample, 10))

    # the flat engine: pca64>rr64, its scan K3 over 1M x 64; recall@10
    # against K3's exact truth in 384-d
    truth = knn.knn_scan(qd[:max(BATCHES)], xd, K)[1]
    for fn in counters:
        fn.launches = 0
    eng_flat, out["flat_build_s"] = timed(
        lambda: build_engine(xd, SPEC_FLAT, device=dev, seed=SEED))
    lat, found = search_timed(torch, eng_flat, qd, BATCHES)
    flat_launches = kt.knn_topk_d2.launches
    others = sum(fn.launches for fn in counters if fn is not kt.knn_topk_d2)
    check(flat_launches > 0 and others == 0, f"the flat engine's searches: "
          f"K3 {flat_launches}, other kernels {others}")
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    out["flat"] = {"spec": SPEC_FLAT, "latency": lat, "recall_at_10": rec,
                   "k3_launches": flat_launches}
    for b in BATCHES:
        log(f"[path 5] {SPEC_FLAT} batch {b:4d}: p50 {lat[b]['p50_ms']:.3f} "
            f"ms qps {lat[b]['qps']:.0f} recall@10 {rec[b]:.4f}")
    check(rec[256] >= RECALL_FLOOR, f"flat recall@10 {rec[256]}")
    st = eng_flat.state
    qf = reduce_vectors(st.proj, qd[:256]).contiguous()
    cand = kt.knn_topk_plain(qf, st.index.payload, RERANK)[1]
    _, ids_plain = exact_rerank(qd[:256], st.corpus, cand, K)
    same = float((ids_plain == found[256]).float().mean())
    out["flat"]["ids_equal_plain_route"] = same
    log(f"[path 5] flat: ids equal to the plain scan route's on {same:.6f} "
        "of slots at batch 256")
    check(same >= 0.999, f"flat ids differ from the plain route ({same})")
    log("[K3 main flat scan]")
    err = max(err, compare_k3(torch, kt, "K3 main flat", qf,
                              st.index.payload, RERANK))

    # F1: a re-rank budget past what K3's lists hold in shared memory: the
    # flat scan takes k = 1024 (global-scratch lists), ids against the
    # plain scan route's
    eng_wide = build_engine(xd, SPEC_FLAT_WIDE, device=dev, seed=SEED)
    n0 = kt.knn_topk_d2.launches
    (_, found_w), wide_s = timed(lambda: eng_wide.search(qd[:WIDE_BATCH], K))
    check(kt.knn_topk_d2.launches - n0 == 1, "the wide flat search did not "
          "launch K3 once")
    sw = eng_wide.state
    qw = reduce_vectors(sw.proj, qd[:WIDE_BATCH]).contiguous()
    cand = kt.knn_topk_plain(qw, sw.index.payload, WIDE_RERANK)[1]
    _, ids_w = exact_rerank(qd[:WIDE_BATCH], sw.corpus, cand, K)
    same_w = float((ids_w == found_w).float().mean())
    rec_w = recall_at_k(found_w, truth[:WIDE_BATCH])
    out["flat_wide"] = {"spec": SPEC_FLAT_WIDE, "batch": WIDE_BATCH,
                        "search_s": wide_s, "recall_at_10": rec_w,
                        "ids_equal_plain_route": same_w}
    log(f"[path 5] {SPEC_FLAT_WIDE} batch {WIDE_BATCH}: {wide_s * 1e3:.2f} "
        f"ms (first call), recall@10 {rec_w:.4f}, ids equal to the plain "
        f"scan route's on {same_w:.6f} of slots")
    check(same_w >= 0.999, f"wide flat ids differ from the plain route "
          f"({same_w})")
    err = max(err, compare_k3(torch, kt, "K3 main flat k=1024", qw,
                              sw.index.payload, WIDE_RERANK))
    del eng_wide, sw, qw, cand

    # the mlp reducer on the main ivfpq path (K1)
    for fn in counters:
        fn.launches = 0
    eng_mlp, out["mlp_build_s"] = timed(
        lambda: build_engine(xd, SPEC_MLP, device=dev, seed=SEED))
    lat, found = search_timed(torch, eng_mlp, qd, BATCHES)
    k1 = {name: next(fn.launches for fn in counters if fn.__name__ == name)
          for name in ("pq_adc_gather_topk", "pq_adc_cells_topk")}
    check(k1["pq_adc_cells_topk"] > 0, "K1's cell-major entry never "
          "launched on the mlp engine")
    entries = k1_entries(torch, kops, eng_mlp, qd, "path 5 mlp")
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    je = SearchEngine.from_state(
        eng_mlp.state, dataclasses.replace(eng_mlp.config, pq_backend="jnp"))
    _, ij = je.search(qd[:256], K)
    check(torch.equal(ij, found[256]), "mlp: @jnp and @kernel ids differ")
    log("[path 5] mlp: @jnp returns the @kernel ids at batch 256")
    out["mlp"] = {"spec": SPEC_MLP, "latency": lat, "recall_at_10": rec,
                  "k1_launches": k1, "k1_entries": entries,
                  "ids_equal_plain_route": 1.0,
                  "build_stages_s": eng_mlp.build_seconds,
                  "residual_kept": bool(
                      eng_mlp.state.proj.params["w2"].abs().max() > 0)}
    for b in BATCHES:
        log(f"[path 5] {SPEC_MLP} batch {b:4d}: p50 {lat[b]['p50_ms']:.3f} "
            f"ms qps {lat[b]['qps']:.0f} recall@10 {rec[b]:.4f}")
    check(rec[256] >= RECALL_FLOOR, f"mlp recall@10 {rec[256]}")
    del eng_mlp, je

    # the exact fit backend on the fit sample at one w, beside the fast
    # one: value rtol 1e-5, gradient atol 5e-3 (tests/test_objective.py's
    # tolerance: f32 rounding may swap a pair at the b% cut)
    xs = sample - sample.mean(dim=0)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        DIM).astype(np.float32)).to(dev)
    w = w / w.norm()
    prev = torch.zeros((2, DIM), device=dev)
    prev[0] = reducers["mpad"].matrix[0]
    mask = torch.tensor([1.0, 0.0], device=dev)
    (ve, ge), exact_s = timed(lambda: mpad_mod._phi_exact_value_and_grad(
        w, xs, prev, mask, b=80.0, alpha=25.0))
    vf, gf = fast_objective.phi_fast_value_and_grad(w, xs, prev, mask,
                                                    b=80.0, alpha=25.0)
    rel = abs(float(ve) - float(vf)) / abs(float(vf))
    gerr = float((ge - gf).abs().max())
    check(rel <= 1e-5 and gerr <= 5e-3, f"exact phi {float(ve)} vs fast "
          f"{float(vf)}, gradient max |diff| {gerr}")
    fit_e, fit_e_s = timed(lambda: fit_mpad(
        sample, MPADConfig(m=4, iters=5, backend="exact"), device=dev))
    check(bool(torch.isfinite(fit_e.matrix).all()), "exact fit not finite")
    out["exact_backend"] = {"phi_rel_diff": rel, "grad_max_abs_diff": gerr,
                            "step_s": exact_s, "fit_m4_iters5_s": fit_e_s,
                            "n_pairs": FIT_SAMPLE * (FIT_SAMPLE - 1) // 2,
                            "selected": objective.num_selected_pairs(
                                FIT_SAMPLE, 80.0)}
    log(f"[path 5] exact backend vs fast on the fit sample: phi rel "
        f"{rel:.2e}, gradient max |diff| {gerr:.2e}; one step "
        f"{exact_s * 1e3:.1f} ms, a fit of 4 x 5 {fit_e_s:.2f} s")

    # K3 timings at the path's shapes
    timings = {
        "truth": k3_timing(torch, kt, "truth", qd, xd, 15),
        "reduced": k3_timing(torch, kt, "reduced", qr, xr, 15),
        "flat": k3_timing(torch, kt, "flat", qf, st.index.payload, RERANK,
                          library=True),
        "transform": k3_timing(torch, kt, "transform", xd, sample, 10)}
    out["k3_timings"] = timings
    del eng_flat, st, xr, qr
    return out, launches, err, timings["flat"]


def k5_tolerance(dtype_name):
    """K5 against its plain version: the tolerances of
    tests/test_flash_attention.py. f32: the same f32 sums in another order
    (atol 2e-5, rtol 1e-4). bf16: both round one f32 result to bf16 once,
    so they differ by at most one bf16 ulp where the f32 sums straddle a
    rounding boundary (atol 3e-2: an ulp of values below 4).

    ``row_rel`` bounds each (query, head) row's ||got - want|| / ||want||,
    a check scaled to the row beside the elementwise one: the output at
    row i of standard-normal inputs has a std of about sqrt(e / i), under
    atol from row 4096 on, so atol alone cannot see a fault in a late K/V
    tile. bf16: 2^-6, two bf16 ulps of the row (an element that straddles
    a rounding boundary moves by at most 2^-7 of itself, P's bf16 rounding
    by about 2^-9 of the row). f32: the rtol. ``edge_cases_k5`` shows that
    one K/V tile left out breaks the bf16 bound."""
    return (dict(atol=2e-5, rtol=1e-4, row_rel=1e-4) if dtype_name == "f32"
            else dict(atol=3e-2, rtol=0.0, row_rel=2.0 ** -6))


def k5_row_rel(torch, got, want):
    """The largest ||got - want|| / ||want|| over (query, head) rows."""
    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def k5_fault_row_rel(torch, q, k, v, window, want):
    """The row check's reading of a planted fault: the plain version with
    the 64-row K/V tile at S/2 left out for every query (its kv_pos set to
    -1, an unwritten slot), as a kernel that skipped that tile would
    return. Its error at row i is about (64 / i) * O(1), the size of a
    double-buffer race or a wrong rescale in a late tile."""
    from repro_torch.models.layers import chunked_attention
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    kv_pos = pos.clone()
    t0 = s // 2 // 64 * 64
    kv_pos[t0:t0 + 64] = -1
    fault = chunked_attention(q, k, v, pos, kv_pos, window=window)
    return k5_row_rel(torch, fault, want)


def compare_k5(torch, fa, name, q, k, v, window, readings=None,
               fault=False):
    """K5 against its plain version on the same CUDA tensors, at
    ``k5_tolerance``, elementwise and by row. With ``fault``, also reads a
    planted fault (``k5_fault_row_rel``) and checks that the row bound
    rejects it. Writes the readings into ``readings[name]``; returns max
    |err|."""
    got = fa.flash_attention_fwd(q, k, v, window)
    torch.cuda.synchronize()
    want = fa.flash_attention_fwd_plain(q, k, v, window)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{name}: output {got.dtype} {tuple(got.shape)}")
    tol = k5_tolerance("f32" if q.dtype == torch.float32 else "bf16")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"{name}: beyond {tol} (max err {err})")
    row = k5_row_rel(torch, got, want)
    check(row <= tol["row_rel"], f"{name}: a row's relative error {row:.3e} "
          f"beyond {tol['row_rel']:.3e}")
    reading = {"max_abs_err": err, "row_rel": row}
    msg = f"  {name}: ok, max |err| {err:.3e}, row rel {row:.3e}"
    if fault:
        reading["fault_row_rel"] = k5_fault_row_rel(torch, q, k, v, window,
                                                    want)
        check(reading["fault_row_rel"] > tol["row_rel"],
              f"{name}: the row bound misses one K/V tile left out "
              f"({reading['fault_row_rel']:.3e})")
        msg += f"; one tile left out reads {reading['fault_row_rel']:.3e}"
    if readings is not None:
        readings[name] = reading
    log(msg)
    return err


def k5_inputs(torch, seed, b, s, h, kv, dh, dtype):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        .to("cuda").to(dtype)
        for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


# (b, s, h, kv, dh, window): S = 1, 16, 80 (ragged), 4096; G = 1 and 8;
# dh = 8, 16, 32, 64, 128, 256; window 16 at S = 1000, wider than S, and 1
K5_EDGES = ((1, 1, 4, 4, 64, None), (2, 16, 8, 1, 8, None),
            (2, 80, 8, 1, 64, None), (1, 80, 4, 4, 128, None),
            (2, 80, 4, 2, 16, 24), (1, 4096, 32, 4, 64, None),
            (1, 1000, 4, 2, 64, 16), (1, 1000, 8, 4, 256, 16),
            (1, 300, 4, 1, 256, 1000), (1, 200, 8, 8, 32, 1),
            (1, 257, 4, 2, 128, 1))


def edge_cases_k5(torch, fa):
    """K5's edge cases on both routes, then the bf16 LM shapes at full
    length; a planted fault read at S 4096 and 32768 (bf16). Returns (max
    |err|, {case: readings})."""
    err, readings = 0.0, {}
    for i, (b, s, h, kv, dh, win) in enumerate(K5_EDGES):
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = k5_inputs(torch, 10 + i, b, s, h, kv, dh, dt)
            err = max(err, compare_k5(
                torch, fa, f"K5 edge {name} B={b} S={s} H={h} KV={kv} "
                f"dh={dh} window={win}", q, k, v, win, readings,
                fault=name == "bf16" and s == 4096))
    # the LM shapes at full length, bf16, against the chunked plain version:
    # TinyLlama at prefill_32k's sequence (batch 32 cut to 1), and
    # Gemma3-4B's local layers (H 8 / KV 4 / dh 256, window 1024)
    for name, (b, s, h, kv, dh, win) in (
            ("tinyllama S=32768", (1, 32768, 32, 4, 64, None)),
            ("gemma3-4b local S=8192", (1, 8192, 8, 4, 256, 1024))):
        q, k, v = k5_inputs(torch, 7, b, s, h, kv, dh, torch.bfloat16)
        err = max(err, compare_k5(torch, fa, f"K5 edge bf16 {name}", q, k, v,
                                  win, readings, fault=s == 32768))
    return err, readings


def k5_bound(b, s, h, kv, dh, window, elem_bytes):
    """The least time of one K5 call: the larger of its operations (a
    multiply-add of q.k and of p.v per head dim per (query, key) pair the
    mask keeps) at the bf16 tensor peak and its bytes (q, k, v read once,
    the output written once) at the HBM rate. Returns (ms, by, ops, bytes)."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w     # causal, within the window
    nops = 4 * dh * pairs * b * h
    nbytes = (2 * b * s * h * dh + 2 * b * s * kv * dh) * elem_bytes
    t_ops, t_bytes = nops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nops, nbytes)


def search_timed(torch, eng, qd, batches, id_bound=N):
    """Searches at each batch: 2 warm-up calls, then 20 timed by CUDA
    events; every id must lie in [0, ``id_bound``). Returns ({batch:
    latency stats}, {batch: ids})."""
    lat, found = {}, {}
    for b in batches:
        qb = qd[:b]
        for _ in range(2):                                # warm-up
            eng.search(qb, K)
        times = []
        for _ in range(20):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            d, i = eng.search(qb, K)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        found[b] = i
        lat[b] = {"p50_ms": float(np.median(times)),
                  "p90_ms": float(np.percentile(times, 90)),
                  "qps": b / (float(np.median(times)) / 1e3),
                  "bucket": eng.last_bucket}
        check(tuple(d.shape) == (b, K) and bool(torch.isfinite(d).all())
              and bool((i >= 0).all()) and bool((i < id_bound).all()),
              f"batch {b}: bad result shape or values")
    return lat, found


def k1_entries(torch, ops, eng, qd, label):
    """Which K1 entry an ivfpq engine's search takes at each batch: one
    search a batch of BATCHES, K1's two counts read around it. The padded
    scan (a bucket above the engine's compact_batch, or the compact scan
    off) must launch the cell-major entry once and the gathered entry
    never; a compact bucket the gathered entry once. Batch 256 must take
    the padded scan. Returns {batch: the scan and the two counts}."""
    out = {}
    for b in BATCHES:
        g0 = ops.pq_adc_gather_topk.launches
        c0 = ops.pq_adc_cells_topk.launches
        eng.search(qd[:b], K)
        torch.cuda.synchronize()
        got = (ops.pq_adc_gather_topk.launches - g0,
               ops.pq_adc_cells_topk.launches - c0)
        compact = (eng.last_bucket <= eng.config.compact_batch
                   and eng._scan_cap(eng.config.nprobe) > 0)
        want = (1, 0) if compact else (0, 1)
        check(got == want, f"{label} batch {b}: K1 gathered / cell-major "
              f"launches {got}, want {want}")
        out[b] = {"bucket": eng.last_bucket,
                  "scan": "compact" if compact else "padded",
                  "gathered": got[0], "cells": got[1]}
    check(out[256]["scan"] == "padded", f"{label}: batch 256 took the "
          "compact scan")
    log(f"[{label}] K1 entry by batch: "
        f"{ {b: v['scan'] + (' gathered' if v['gathered'] else ' cells') for b, v in out.items()} }")
    return out


def kmeans_repeat(torch, ivf, xr, nlist, gen):
    """F2: k-means at the path's cell count, twice on one input from the
    same starting rows; the centroids must match bit for bit (the cluster
    sums are fixed-order segment sums, not float atomics). Returns the
    result dict."""
    init = torch.randperm(xr.shape[0], generator=gen)[:nlist]
    cents, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cents.append(ivf.kmeans(xr, nlist, init=init))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(torch.equal(cents[0], cents[1]), "k-means does not repeat bit for "
          "bit on the card")
    check(bool(torch.isfinite(cents[0]).all()), "k-means centroids not "
          "finite")
    log(f"[F2] k-means of {tuple(xr.shape)} into {nlist} cells, twice: "
        f"centroids bit for bit ({[round(t, 3) for t in secs]} s)")
    return {"rows": xr.shape[0], "dim": xr.shape[1], "nlist": nlist,
            "seconds": secs, "bit_equal": True}


def pq1024_path(torch, mods, xd, qd, counters):
    """F3: the pq kind with K 1024 (int32 codes) on K2 over a cut of the
    corpus: build, searches at every batch, recall@10 against exact search
    on the cut, and the @jnp (plain scan) route's ids."""
    ops, knn, build_engine, SearchEngine, recall_at_k = mods
    dev = xd.device
    xc = xd[:PQ1024_ROWS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = build_engine(xc, SPEC_PQ1024, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out = {"spec": SPEC_PQ1024, "rows": PQ1024_ROWS,
           "build_s": time.perf_counter() - t0}
    codes = eng.state.index.payload.codes
    check(codes.dtype == torch.int32, f"K 1024 codes are {codes.dtype}")
    for fn in counters:
        fn.launches = 0
    lat, found = search_timed(torch, eng, qd, BATCHES)
    k2 = ops.pq_adc_topk.launches
    check(k2 > 0, "K2 never launched on the K 1024 engine")
    truth = knn.knn_scan(qd, xc, K)[1]
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    je = SearchEngine.from_state(
        eng.state, dataclasses.replace(eng.config, pq_backend="jnp"))
    _, ij = je.search(qd, K)
    check(torch.equal(ij, found[256]), "K 1024: @jnp and @kernel ids differ")
    out.update(latency=lat, recall_at_10=rec, k2_launches=k2,
               ids_equal_plain_route=1.0)
    for b in BATCHES:
        log(f"[F3] {SPEC_PQ1024} on {PQ1024_ROWS} rows, batch {b:4d}: p50 "
            f"{lat[b]['p50_ms']:.3f} ms recall@10 {rec[b]:.4f}")
    log(f"[F3] build {out['build_s']:.2f} s; K2 launches {k2}; @jnp returns "
        "the @kernel ids at batch 256")
    check(rec[256] >= RECALL_FLOOR, f"K 1024 recall@10 {rec[256]}")
    return out


def cand_by_id(torch, cand, alive):
    """``cand`` with the ids of rows that ``alive`` (N,) marks false set to
    -1, masked by row id as the JAX package masks its scan's base: the cand
    route's input."""
    return torch.where((cand >= 0) & alive[cand.clamp_min(0)], cand, -1)


def k1_masked_time(torch, ops, ivfpq, tables, scale, probe, cd2p, store,
                   alive, cand, cell_len, k):
    """K1's cell-major entry on a streaming store at batch 256, three
    routes on the same cells: the fills with the cell-major live byte map
    (what the streaming scan launches), the candidate ids with the dead
    ones -1 (the cand route), and the fills alone (the read-only scan's
    route, which would score the dead rows too); each a call's time by
    CUDA events and its kernels' device time. Beside them, what each
    masked route makes before its launch, timed the same way: the map
    (``ivfpq.live_cells``, once a search) and the cand route's masked ids
    (``cand_by_id``). The live route's plain version, and its bound: the
    distinct probed cells' filled rows once (``k1_bounds``) and their
    bytes of the map, which the kernel reads only below a cell's fill."""
    cc, bc = store.codes_cell, store.bias_cell
    live = ivfpq.live_cells(store.lists, alive)
    masked = cand_by_id(torch, cand, alive)
    routes = {
        "live": lambda: ops.pq_adc_cells_topk(
            tables, probe, cd2p, cc, bc, cand, k, "int8", scale, cell_len,
            live),
        "cand": lambda: ops.pq_adc_cells_topk(tables, probe, cd2p, cc, bc,
                                              masked, k, "int8", scale),
        "cell_len": lambda: ops.pq_adc_cells_topk(
            tables, probe, cd2p, cc, bc, cand, k, "int8", scale, cell_len)}
    out = {}
    for name, fn in routes.items():
        out[f"{name}_ms"] = cuda_ms(torch, fn, reps=20)
        out[f"{name}_device_ms"] = device_ms(torch, fn, reps=5,
                                             match=("adc_", "select_topk"))
    out["map_build_ms"] = cuda_ms(
        torch, lambda: ivfpq.live_cells(store.lists, alive), reps=20)
    out["cand_mask_ms"] = cuda_ms(
        torch, lambda: cand_by_id(torch, cand, alive), reps=20)
    out["live_total_ms"] = out["map_build_ms"] + out["live_ms"]
    out["cand_total_ms"] = out["cand_mask_ms"] + out["cand_ms"]
    out["live_plain_ms"] = cuda_ms(torch, lambda: ops.pq_adc_cells_topk_plain(
        tables, probe, cd2p, cc, bc, cand, k, "int8", scale, live), reps=3,
        warmup=1)
    base = torch.where(masked >= 0, 0.0, float("inf"))
    bd = k1_bounds(torch, tables, probe, cc, cell_len, k, base)["cells"]
    nbytes = bd["bytes"] + bd["distinct_rows"]
    tb, to = nbytes / HBM_BYTES_PER_S, bd["ops"] / F32_OPS_PER_S
    out.update(bound_ms=max(tb, to) * 1e3,
               bound_by="bytes" if tb >= to else "operations",
               bound_bytes=nbytes, C=int(cand.shape[1]),
               map_bytes=bd["distinct_rows"],
               live_slots=int((masked >= 0).sum()))
    for name in ("live", "cand"):
        out[f"{name}_over_cell_len"] = (out[f"{name}_device_ms"]
                                        / out["cell_len_device_ms"])
    log(f"[path 6] K1 cell-major entry at Q {probe.shape[0]} C {out['C']} "
        f"(int8), ms a call (of its kernels): live route "
        f"{out['live_ms']:.4f} ({out['live_device_ms']:.4f}), cand route "
        f"{out['cand_ms']:.4f} ({out['cand_device_ms']:.4f}), fills alone "
        f"{out['cell_len_ms']:.4f} ({out['cell_len_device_ms']:.4f}); "
        f"live / fills {out['live_over_cell_len']:.3f}, cand / fills "
        f"{out['cand_over_cell_len']:.3f}; before the launch: the map "
        f"{out['map_build_ms']:.4f} ms, the masked ids "
        f"{out['cand_mask_ms']:.4f} ms; with them: live route "
        f"{out['live_total_ms']:.4f}, cand route {out['cand_total_ms']:.4f} "
        f"ms; plain {out['live_plain_ms']:.3f} ms; bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {nbytes} B)")
    return out


def stream_path(torch, mods, eng, xd, qd, counters):
    """Path 6: path 1's engine made streaming (``SearchEngine.from_state``
    with ``StreamConfig(delta_capacity=1024)``), then the write leg: 256
    batches of 64 new ids near existing rows plus 8 overwritten base ids,
    each batch deleting 8 of the previous batch's new ids, 64 queries
    searched every 8 batches. Checks (a)-(g) of the module docstring; the
    write rates, compaction seconds, grows, p50 / QPS beside the read-only
    engine's, K1's launches on the live route and its time against the
    cand route and the fills alone, the card's busy share. Returns (result dict, K1
    launches in the run, K1's max |err| on the path's inputs)."""
    (ops, ref, ivfpq, knn, SearchEngine, StreamConfig, segments,
     recall_at_k, adc_tables, probe_cells, reduce_vectors, tree_map) = mods
    dev = xd.device
    out = {"spec": SPEC, "delta_capacity": STREAM_DELTA}
    cfg = dataclasses.replace(eng.config, stream=StreamConfig(
        delta_capacity=STREAM_DELTA))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_eng = SearchEngine.from_state(eng.state, cfg)
    torch.cuda.synchronize()
    out["make_mutable_s"] = time.perf_counter() - t0
    st = s_eng.store
    out["store"] = {"n_cap": int(st.corpus.shape[0]),
                    "mc_cap": int(st.lists.shape[1])}
    # (a) fresh: the read-only engine's ids at every batch, both timed
    lat_ro, found_ro = search_timed(torch, eng, qd, BATCHES)
    lat_fresh, found_fresh = search_timed(torch, s_eng, qd, BATCHES)
    for b in BATCHES:
        check(torch.equal(found_fresh[b], found_ro[b]),
              f"path 6 (a): fresh streaming ids differ at batch {b}")
    log(f"[path 6] (a) fresh streaming engine: the read-only ids at batches "
        f"{BATCHES}; make_mutable {out['make_mutable_s']:.2f} s, store "
        f"{out['store']}")

    # the write leg; compactions timed through the engine's fold
    folds = []
    run_compact = s_eng._run_compact

    def timed_compact(store):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_compact(store)
        torch.cuda.synchronize()
        folds.append(time.perf_counter() - t)
        return res

    s_eng._run_compact = timed_compact
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    overwrite = torch.from_numpy(rng.choice(
        N, STREAM_BATCHES * STREAM_OVERWRITE, replace=False)).to(dev)
    deleted = torch.zeros(0, dtype=torch.int64, device=dev)
    up_s = del_s = 0.0
    n_up = n_del = 0
    prev_new = None
    checks = {}
    q64 = qd[:STREAM_Q]
    for fn in counters:
        fn.launches = 0
    for bi in range(STREAM_BATCHES):
        new = torch.arange(N + bi * STREAM_NEW, N + (bi + 1) * STREAM_NEW,
                           device=dev)
        ow = overwrite[bi * STREAM_OVERWRITE:(bi + 1) * STREAM_OVERWRITE]
        src = torch.cat([torch.randint(0, N, (STREAM_NEW,), generator=gen,
                                       device=dev), ow])
        ids = torch.cat([new, ow])
        vecs = xd[src] + STREAM_NOISE * torch.randn(
            (ids.shape[0], DIM), generator=gen, device=dev)
        torch.cuda.synchronize()
        n_folds = len(folds)
        t0 = time.perf_counter()
        s_eng.upsert(ids, vecs)
        torch.cuda.synchronize()
        up_s += time.perf_counter() - t0 - sum(folds[n_folds:])
        n_up += ids.shape[0]
        deleted = deleted[~torch.isin(deleted, ids)]
        if prev_new is not None:
            gone = prev_new[torch.randperm(STREAM_NEW, generator=gen,
                                           device=dev)[:STREAM_DELETE]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_eng.delete(gone)
            torch.cuda.synchronize()
            del_s += time.perf_counter() - t0
            n_del += gone.shape[0]
            deleted = torch.cat([deleted, gone])
        prev_new = new
        done = bi + 1
        if done % STREAM_SEARCH_EVERY == 0 or done in STREAM_AT:
            d, i = s_eng.search(q64, K)
            # (c) deleted ids never come back; the last batch's rows, queried,
            # return their own ids at distance 0
            check(not bool(torch.isin(i, deleted).any()),
                  f"path 6 (c): a deleted id came back after batch {done}")
            keep = ~torch.isin(new, deleted)
            d_own, i_own = s_eng.search(vecs[:STREAM_NEW][keep], K)
            check(torch.equal(i_own[:, 0], new[keep]) and
                  float(d_own[:, 0].max()) < 1e-3,
                  f"path 6 (c): an upserted row does not find itself after "
                  f"batch {done}")
        if done in STREAM_AT:
            st = s_eng.store
            checks[done] = {
                "delta_rows": int(segments.delta_alive(st).sum()),
                "dead": int(st.dead.sum()), "n_rows": int(st.n_rows),
                "n_cap": int(st.corpus.shape[0]),
                "compactions": s_eng.counters["compactions"],
                "grows": s_eng.grow_count}
            log(f"[path 6] after write batch {done}: {checks[done]}")
        if done == STREAM_BATCHES // 2:
            # (f) a background fold with searches in flight against the
            # blocking fold of a copy of the same store
            twin = SearchEngine.from_store(
                tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                         s_eng.store), s_eng.frozen, cfg)
            twin.compact()
            s_eng.begin_compact()
            inflight = [s_eng.search(qd, K)[1] for _ in range(4)]
            s_eng.finish_compact()
            _, i_bg = s_eng.search(qd, K)
            _, i_bl = twin.search(qd, K)
            check(torch.equal(i_bg, i_bl), "path 6 (f): the background "
                  "fold's ids differ from the blocking fold's")
            check(all(x.shape == (qd.shape[0], K) for x in inflight),
                  "path 6 (f): a search in flight failed")
            out["background_fold"] = {"at_batch": done, "ids_equal": True,
                                      "searches_in_flight": len(inflight)}
            log(f"[path 6] (f) after batch {done}: begin_compact with 4 "
                "searches in flight, then finish_compact: the blocking "
                "fold's ids")
            del twin, inflight
    s_eng._run_compact = run_compact
    k1_launches = ops.pq_adc_cells_topk.launches
    out["k1_launches_live_route"] = k1_launches
    check(k1_launches > 0 and ops.pq_adc_gather_topk.launches == 0,
          f"path 6: K1's cell-major entry launched {k1_launches} times, the "
          f"gathered entry {ops.pq_adc_gather_topk.launches}")
    out["writes"] = {
        "upserts": n_up, "deletes": n_del,
        "upsert_rows_per_s": n_up / up_s, "delete_ids_per_s": n_del / del_s,
        "compactions": s_eng.counters["compactions"],
        "compaction_s": folds, "grow_count": s_eng.grow_count}
    log(f"[path 6] {n_up} upserts ({n_up / up_s:.0f} rows/s, compactions "
        f"excluded), {n_del} deletes ({n_del / del_s:.0f} ids/s); "
        f"{len(folds)} compactions, {np.mean(folds):.4f} s each (max "
        f"{max(folds):.4f}); grow_count {s_eng.grow_count}; K1 cell-major "
        f"launches {k1_launches}")
    check(s_eng.grow_count > 0, "path 6: the write leg never grew the store")

    # (b) mid-stream: @jnp on the same store, and K1 on its own inputs
    st, fr = s_eng.store, s_eng.frozen
    check(int(segments.delta_alive(st).sum()) > 0 and bool(st.dead.any()),
          "path 6 (b): the delta is empty or no row is dead")
    lat_mid, found_mid = search_timed(torch, s_eng, qd, BATCHES,
                                      id_bound=N + STREAM_BATCHES
                                      * STREAM_NEW)
    plain = SearchEngine.from_store(st, fr, dataclasses.replace(
        cfg, pq_backend="jnp"))
    for b in BATCHES:
        check(torch.equal(plain.search(qd[:b], K)[1], found_mid[b]),
              f"path 6 (b): @jnp and @kernel streaming ids differ at {b}")
    qr = reduce_vectors(fr.proj, qd)
    probe, cand, cd2p = probe_cells(fr.centroids, st.lists, qr,
                                    cfg.nprobe, cfg.rerank)
    alive = segments.live_mask(st)
    live = ivfpq.live_cells(st.lists, alive)
    fill = (st.lists >= 0).sum(dim=1)
    tables = adc_tables(fr.lut_w, fr.cbnorm, qr)
    center, scale = ivfpq.ivfpq_lut_stats(fr.codebooks, fr.cbnorm, qr,
                                          "int8")
    kt = tables - center[:, :, None]
    k_eff = min(cfg.rerank, cand.shape[1])
    cells_in = (probe, cd2p, st.codes_cell, st.bias_cell, cand)
    err = compare_k1_cells(torch, ops, ref, "path 6 masked int8, live map",
                           kt, *cells_in, k_eff, "int8", scale, fill, live)
    by_id = cand_by_id(torch, cand, alive)
    err = max(err, compare_k1_cells(
        torch, ops, ref, "path 6 masked int8, cand", kt, *cells_in[:4],
        by_id, k_eff, "int8", scale))
    got = ops.pq_adc_cells_topk(kt, *cells_in, k_eff, "int8", scale, fill,
                                live)
    want = ops.pq_adc_cells_topk(kt, *cells_in[:4], by_id, k_eff, "int8",
                                 scale)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "path 6 (b): K1 on the cell-major live map differs from K1 on "
          "the ids masked by row")
    log("[path 6] (b) mid-stream: @jnp returns the @kernel ids at every "
        "batch; K1's masked scan (live map and cand routes) bit-equal to "
        "its plain version and to each other")
    out["k1_timing"] = k1_masked_time(torch, ops, ivfpq, kt, scale, probe,
                                      cd2p, st, alive, cand, fill, k_eff)
    out["device_busy"] = {b: device_busy(torch, s_eng, qd[:b],
                                         f"path 6 batch {b}")
                          for b in (1, 256)}
    del plain, tables, kt, cand, live, by_id, got, want, probe, cd2p, qr

    # (d) the final compaction against a rebuild over the survivors
    s_eng.compact()
    st = s_eng.store
    live = segments.live_mask(st)
    surv, ext = st.corpus[live], st.row_ids[live]
    out["survivors"] = int(ext.shape[0])
    check(out["survivors"] == N + n_up - STREAM_BATCHES * STREAM_OVERWRITE
          - n_del, f"path 6: {out['survivors']} survivors")
    _, i_s = s_eng.search(qd, K)
    oracle = SearchEngine.from_state(
        segments.rebuild_state(s_eng.frozen, surv),
        dataclasses.replace(cfg, stream=None))
    _, i_r = oracle.search(qd, K)
    check(torch.equal(i_s.sort(dim=1).values, ext[i_r].sort(dim=1).values),
          "path 6 (d): the compacted engine's ids differ from the rebuild's")
    # (e) recall@10 against exact search over the survivors (K3)
    truth = ext[knn.knn_scan(qd, surv, K)[1]]
    rec = recall_at_k(i_s, truth)
    out["recall_at_10"] = rec
    check(rec >= RECALL_FLOOR, f"path 6 (e): recall@10 {rec}")
    log(f"[path 6] (d) after the final compact: the ids of an engine over "
        f"rebuild_state(frozen, survivors); (e) recall@10 {rec:.4f} against "
        f"exact search over the {out['survivors']} survivors")
    lat_end, _ = search_timed(torch, s_eng, qd, BATCHES,
                              id_bound=N + STREAM_BATCHES * STREAM_NEW)
    del oracle, surv, truth
    # (g) vacuum keeps the survivors' ids
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_eng.vacuum()
    torch.cuda.synchronize()
    out["vacuum_s"] = time.perf_counter() - t0
    check(torch.equal(s_eng.search(qd, K)[1].sort(dim=1).values,
                      i_s.sort(dim=1).values),
          "path 6 (g): vacuum changed the survivors' ids")
    log(f"[path 6] (g) vacuum in {out['vacuum_s']:.2f} s: the survivors' "
        "ids unchanged")
    out["latency"] = {"read_only": lat_ro, "fresh": lat_fresh,
                      "mid_stream": lat_mid, "compacted": lat_end}
    out["checks_by_batch"] = checks
    for b in BATCHES:
        log(f"[path 6] batch {b:4d}: p50 read-only {lat_ro[b]['p50_ms']:.3f}"
            f" ms, streaming fresh {lat_fresh[b]['p50_ms']:.3f}, mid-stream "
            f"{lat_mid[b]['p50_ms']:.3f}, compacted "
            f"{lat_end[b]['p50_ms']:.3f}; QPS {lat_ro[b]['qps']:.0f} / "
            f"{lat_fresh[b]['qps']:.0f} / {lat_mid[b]['qps']:.0f} / "
            f"{lat_end[b]['qps']:.0f}")
    s_eng.close()
    return out, k1_launches, err


def dir_bytes(path):
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def filesystem(path):
    """The filesystem type ``path`` lies on (``stat -f``)."""
    return subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def same_store(torch, a, b):
    """Every tensor of two StreamStores equal, dtype and bits."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and not (x.dtype == y.dtype and torch.equal(x, y)):
            return False
    return True


def live_rows(torch, segments, store):
    """(vectors, external ids) of every live row: base, then delta."""
    live = segments.live_mask(store)
    alive = segments.delta_alive(store)
    return (torch.cat([store.corpus[live], store.delta_vectors[alive]]),
            torch.cat([store.row_ids[live], store.delta_ids[alive]]))


class WriteLeg:
    """Path 6's write mix, batch by batch, on one or more engines: 64 new
    ids near existing rows and 8 overwritten base ids upserted, 8 of the
    previous batch's new ids deleted. Keeps the deleted ids and times each
    engine's calls (host clock, synchronized)."""

    def __init__(self, torch, xd, seed, first_id):
        self.torch, self.xd = torch, xd
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=xd.device).manual_seed(seed)
        self.next_id = first_id
        self.prev_new = None
        self.deleted = torch.zeros(0, dtype=torch.int64, device=xd.device)
        self.overwritten = set()

    def batch(self):
        """The next batch: (ids, vectors, ids to delete or None)."""
        torch, dev, n = self.torch, self.xd.device, self.xd.shape[0]
        new = torch.arange(self.next_id, self.next_id + STREAM_NEW,
                           device=dev)
        self.next_id += STREAM_NEW
        ow = self.rng.choice(n, STREAM_OVERWRITE, replace=False)
        ow = torch.from_numpy(ow).to(dev)
        src = torch.cat([torch.randint(0, n, (STREAM_NEW,),
                                       generator=self.gen, device=dev), ow])
        ids = torch.cat([new, ow])
        vecs = self.xd[src] + STREAM_NOISE * torch.randn(
            (ids.shape[0], DIM), generator=self.gen, device=dev)
        gone = None
        if self.prev_new is not None:
            gone = self.prev_new[torch.randperm(
                STREAM_NEW, generator=self.gen, device=dev)[:STREAM_DELETE]]
        self.prev_new = new
        self.deleted = self.deleted[~torch.isin(self.deleted, ids)]
        if gone is not None:
            self.deleted = torch.cat([self.deleted, gone])
        return ids, vecs, gone

    def run(self, engines, n, clocks=None):
        """``n`` batches on every engine; ``clocks`` (one list of seconds
        an engine) gathers each engine's upsert time."""
        torch = self.torch
        for _ in range(n):
            ids, vecs, gone = self.batch()
            for j, e in enumerate(engines):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.upsert(ids, vecs)
                torch.cuda.synchronize()
                if clocks is not None:
                    clocks[j].append(time.perf_counter() - t0)
                if gone is not None:
                    e.delete(gone)


def wal_rates(torch, mods, xd, root, leg_seed):
    """(d): durable upsert rows/s under each fsync mode on a cut of path
    1's state (PERSIST_RATE_ROWS rows, the same frozen quantizers), the
    same write mix; then PERSIST_THREADS threads appending RT_UPSERT
    records of 72 x 384 to one Wal under fsync always with group commit.
    Host and disk numbers."""
    (SearchEngine, StreamConfig, segments, DurabilityConfig, Wal, wal_mod,
     frozen, cfg) = mods
    out = {"cut_rows": PERSIST_RATE_ROWS, "batches": PERSIST_RATE_BATCHES}
    state = segments.rebuild_state(frozen, xd[:PERSIST_RATE_ROWS])
    rows_per_batch = STREAM_NEW + STREAM_OVERWRITE
    for mode in ("never", "batch", "always"):
        e = SearchEngine.from_state(state, cfg)
        e.durable(os.path.join(root, f"rate_{mode}"),
                  DurabilityConfig(fsync=mode))
        leg = WriteLeg(torch, xd[:PERSIST_RATE_ROWS], leg_seed,
                       first_id=N + 10_000_000)
        clock = [[]]
        leg.run([e], PERSIST_RATE_BATCHES, clock)
        st = e._wal.stats()
        out[mode] = {"upsert_rows_per_s": rows_per_batch
                     * PERSIST_RATE_BATCHES / sum(clock[0]),
                     "fsyncs": st["fsyncs"], "records": st["records"]}
        e.close()
        log(f"[path 7] (d) fsync={mode}: {out[mode]['upsert_rows_per_s']:.0f}"
            f" durable upsert rows/s on the {PERSIST_RATE_ROWS}-row cut "
            f"({st['records']} records, {st['fsyncs']} fsyncs)")
        del e
    del state
    # group commit: concurrent appenders share fsyncs
    wal = Wal(os.path.join(root, "group_commit"), DurabilityConfig(
        fsync="always", group_commit_ms=PERSIST_GROUP_MS))
    rng = np.random.default_rng(SEED + 7)
    rec = wal_mod.encode_upsert(
        np.arange(rows_per_batch, dtype=np.int32),
        rng.standard_normal((rows_per_batch, DIM), dtype=np.float32))

    def writer():
        for _ in range(PERSIST_RECORDS):
            wal.append(wal_mod.RT_UPSERT, rec)

    threads = [threading.Thread(target=writer)
               for _ in range(PERSIST_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "path 7 (d): a group-commit writer did not finish")
    st = wal.stats()
    wal.close()
    total = PERSIST_THREADS * PERSIST_RECORDS
    check(st["records"] == total and st["durable_seq"] == total - 1,
          f"path 7 (d): group commit wrote {st['records']} of {total}")
    got = [seq for seq, _, _ in wal_mod.iter_records(
        os.path.join(root, "group_commit"))]
    check(got == list(range(total)), "path 7 (d): group commit lost or "
          "reordered a record")
    out["group_commit"] = {
        "threads": PERSIST_THREADS, "records": total,
        "record_bytes": len(rec), "group_commit_ms": PERSIST_GROUP_MS,
        "records_per_s": total / dt, "fsyncs": st["fsyncs"],
        "fsyncs_per_record": st["fsyncs"] / total,
        "group_commits": st["group_commits"]}
    log(f"[path 7] (d) group commit: {PERSIST_THREADS} threads, {total} "
        f"records of {len(rec)} bytes in {dt:.3f} s ({total / dt:.0f} "
        f"records/s), {st['fsyncs'] / total:.3f} fsyncs a record")
    return out


def persist_path(torch, mods, eng, xd, qd, build_s):
    """Path 7: snapshots, the write-ahead log, crash recovery and a
    WAL-shipping follower on path 1's state (module docstring, phase 28).
    Returns (result dict, K1 cell-major launches in the path)."""
    (ops, knn, SearchEngine, StreamConfig, segments, recall_at_k,
     load_engine, durability, recovery, wal_mod) = mods
    DurabilityConfig, Wal = durability.DurabilityConfig, durability.Wal
    wall0 = time.perf_counter()
    out = {"spec": SPEC}
    root = os.path.join(HERE, "chiprun_out", "path7_snapshots")
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    # one streaming snapshot's bytes: every tensor of the store the
    # durable engine will hold (corpus and reduced rows padded to the row
    # capacity, codes, lists, the delta)
    cfg = dataclasses.replace(eng.config, stream=StreamConfig(
        delta_capacity=STREAM_DELTA))
    ix = eng.state.index.payload
    m = ix.codes.shape[1]
    per_row = 4 * DIM + 4 * 64 + m + 4 + 4 + 1  # corpus, reduced, codes,
    #                                             bias, row_ids, dead
    cells = ix.lists.shape[0] * (ix.lists.shape[1] + STREAM_DELTA)
    snap_bytes = (N + 4 * STREAM_DELTA) * per_row + cells * (4 + m + 4)
    free = shutil.disk_usage(root).free
    out["disk"] = {"dir": os.path.relpath(root, HERE), "free_bytes": free,
                   "filesystem": filesystem(root),
                   "snapshot_bytes_estimate": snap_bytes}
    log(f"[path 7] {free} bytes free under {out['disk']['dir']} "
        f"({out['disk']['filesystem']}); a snapshot ~{snap_bytes} bytes")
    check(free >= 3 * snap_bytes, f"path 7: {free} bytes free, fewer than "
          f"three snapshots' worth ({3 * snap_bytes})")
    k1_path7 = 0
    try:
        # (a) the read-only engine: save, load, the same answers
        ro_dir = os.path.join(root, "read_only")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = eng.save(ro_dir)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        ro = load_engine(ro_dir, device=xd.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = {b: eng.search(qd[:b], K) for b in BATCHES}
        ops.pq_adc_cells_topk.launches = 0
        ops.pq_adc_gather_topk.launches = 0
        for b in BATCHES:
            d1, i1 = ro.search(qd[:b], K)
            check(torch.equal(want[b][1], i1) and torch.equal(want[b][0], d1),
                  f"path 7 (a): the restored engine's answers differ at "
                  f"batch {b}")
        lat_ro, _ = search_timed(torch, ro, qd, (256,))
        k1_ro = ops.pq_adc_cells_topk.launches
        k1_path7 += k1_ro
        check(k1_ro > 0, "path 7 (a): the restored engine never launched "
              "K1's cell-major entry")
        lat_orig, _ = search_timed(torch, eng, qd, (256,))
        out["read_only"] = {
            "save_s": save_s, "load_s": load_s, "bytes": nbytes,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "load_gb_per_s": nbytes / load_s / 1e9,
            "k1_cells_launches": k1_ro,
            "p50_ms_256": {"original": lat_orig[256]["p50_ms"],
                           "restored": lat_ro[256]["p50_ms"]}}
        log(f"[path 7] (a) read-only: save {save_s:.2f} s, load "
            f"{load_s:.2f} s, {nbytes / 1e9:.3f} GB ({nbytes / save_s / 1e9:.2f}"
            f" / {nbytes / load_s / 1e9:.2f} GB/s); ids and distances equal "
            f"at {BATCHES}; K1 cell-major launches {k1_ro}; p50 at 256 "
            f"original {lat_orig[256]['p50_ms']:.3f} ms, restored "
            f"{lat_ro[256]['p50_ms']:.3f}")
        del ro
        shutil.rmtree(ro_dir)

        # (b) a durable streaming engine beside an oracle that is not
        ddir = os.path.join(root, "durable")
        prim = SearchEngine.from_state(eng.state, cfg)
        oracle = SearchEngine.from_state(eng.state, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prim.durable(ddir, DurabilityConfig(fsync="batch"))
        durable_s = time.perf_counter() - t0
        first = dir_bytes(ddir)
        leg = WriteLeg(torch, xd, SEED + 7, first_id=N)
        clocks = [[], []]
        leg.run([prim, oracle], PERSIST_BATCHES, clocks)
        rows = (STREAM_NEW + STREAM_OVERWRITE) * PERSIST_BATCHES
        check(prim.counters["compactions"] >= 2, "path 7 (b): the write "
              f"leg compacted {prim.counters['compactions']} times")
        prim.vacuum()
        oracle.vacuum()
        t0 = time.perf_counter()
        full = prim.save(ddir)
        full_s = time.perf_counter() - t0
        seed_dir = os.path.join(root, "follower_seed")
        os.makedirs(seed_dir)
        for f in ("engine.json", os.path.basename(full)):
            shutil.copy2(os.path.join(ddir, f), os.path.join(seed_dir, f))
        leg.run([prim, oracle], PERSIST_INC_BATCHES)
        check(prim.counters["compactions"] == oracle.counters["compactions"]
              and not prim._base_dirty, "path 7 (b): a compaction before "
              "the incremental save")
        t0 = time.perf_counter()
        inc = prim.save(ddir, incremental=True)
        inc_s = time.perf_counter() - t0
        leg.run([prim, oracle], PERSIST_TAIL_BATCHES)
        # the crash: the batch's upsert lands, its delete is logged, and
        # the process dies before the delete reaches the store
        ids, vecs, gone = leg.batch()
        prim.upsert(ids, vecs)
        oracle.upsert(ids, vecs)
        seq0 = prim._wal.last_seq

        def crash(point):
            if point == "wal_appended":
                raise SmokeFailure("injected crash")

        prim.crash_hook = crash
        crashed = False
        try:
            prim.delete(gone)
        except SmokeFailure:
            crashed = True
        check(crashed, "path 7 (b): the crash hook did not fire")
        logged = list(wal_mod.iter_records(os.path.join(ddir, "wal"),
                                           after=seq0))
        check([r[1] for r in logged] == [wal_mod.RT_DELETE],
              f"path 7 (b): the crash left {len(logged)} records past the "
              "upsert")
        durability.replay_records(oracle, logged)   # the logged record
        n_log = prim._wal.last_seq + 1
        del prim
        torch.cuda.synchronize()
        replay_clock = {}
        replay = recovery.replay

        def timed_replay(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = replay(*a, **kw)
            torch.cuda.synchronize()
            replay_clock["s"] = time.perf_counter() - t
            replay_clock["stats"] = res
            return res

        recovery.replay = timed_replay
        try:
            t0 = time.perf_counter()
            rec = load_engine(ddir, device=xd.device)
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
        finally:
            recovery.replay = replay
        stats = replay_clock["stats"]
        check(same_store(torch, rec.store, oracle.store),
              "path 7 (b): the recovered store differs from the oracle's")
        ops.pq_adc_cells_topk.launches = 0
        ops.pq_adc_gather_topk.launches = 0
        for b in BATCHES:
            _, i_r = rec.search(qd[:b], K)
            _, i_o = oracle.search(qd[:b], K)
            check(torch.equal(i_r, i_o), f"path 7 (b): recovered ids differ "
                  f"from the oracle's at batch {b}")
            check(not bool(torch.isin(i_r, leg.deleted).any()),
                  f"path 7 (b): a deleted id came back at batch {b}")
        k1_rec = ops.pq_adc_cells_topk.launches
        k1_path7 += k1_rec
        check(k1_rec > 0 and ops.pq_adc_gather_topk.launches == 0,
              f"path 7 (b): K1's live route launched {k1_rec} times")
        surv, ext = live_rows(torch, segments, rec.store)
        truth = ext[knn.knn_scan(qd, surv, K)[1]]
        recall = recall_at_k(rec.search(qd, K)[1], truth)
        check(recall >= RECALL_FLOOR, f"path 7 (b): recall@10 {recall}")
        del surv, truth
        out["durable"] = {
            "fsync": "batch", "durable_s": durable_s,
            "initial_snapshot_bytes": first,
            "write_batches": PERSIST_BATCHES + PERSIST_INC_BATCHES
            + PERSIST_TAIL_BATCHES + 1,
            "upsert_rows_per_s": {"durable": rows / sum(clocks[0]),
                                  "not_durable": rows / sum(clocks[1])},
            "compactions": oracle.counters["compactions"],
            "full_save_s": full_s, "full_bytes": os.path.getsize(full),
            "incremental_save_s": inc_s,
            "incremental_bytes": os.path.getsize(inc),
            "wal_records_written": n_log,
            "recover_s": recover_s, "replay_s": replay_clock["s"],
            "load_s": recover_s - replay_clock["s"],
            "replayed_records": stats.records, "replayed_rows": stats.rows,
            "replayed_compactions": stats.compactions,
            "replay_records_per_s": stats.records / replay_clock["s"],
            "build_s": build_s, "k1_cells_launches": k1_rec,
            "recall_at_10": recall}
        r = out["durable"]
        log(f"[path 7] (b) durable(fsync=batch) {durable_s:.2f} s "
            f"({first / 1e9:.3f} GB); {r['write_batches']} write batches, "
            f"{r['compactions']} compactions, upserts "
            f"{r['upsert_rows_per_s']['durable']:.0f} rows/s durable, "
            f"{r['upsert_rows_per_s']['not_durable']:.0f} not; full save "
            f"{full_s:.2f} s ({r['full_bytes'] / 1e9:.3f} GB), incremental "
            f"{inc_s:.3f} s ({r['incremental_bytes'] / 1e6:.2f} MB)")
        log(f"[path 7] (b) crash at wal_appended inside a delete; recovered "
            f"in {recover_s:.2f} s (load {r['load_s']:.2f}, replay "
            f"{r['replay_s']:.3f} s: {stats.records} records, {stats.rows} "
            f"rows, {stats.compactions} compactions, "
            f"{r['replay_records_per_s']:.0f} records/s) against path 1's "
            f"build {build_s:.1f} s; store bit-equal to the oracle's, ids "
            f"equal at {BATCHES}, no deleted id, K1 live-route launches "
            f"{k1_rec}, recall@10 {recall:.4f}")
        del oracle

        # (c) a follower from a copy of the full snapshot
        t0 = time.perf_counter()
        fol = durability.seed_follower(seed_dir, device=xd.device)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        src = durability.LocalDirSource(ddir)
        t0 = time.perf_counter()
        c1 = durability.catch_up(fol, src)
        torch.cuda.synchronize()
        c1_s = time.perf_counter() - t0
        check(c1.lag_seq == 0 and same_store(torch, fol.store, rec.store),
              "path 7 (c): the follower's store differs from the primary's")
        for b in BATCHES:
            check(torch.equal(fol.search(qd[:b], K)[1],
                              rec.search(qd[:b], K)[1]),
                  f"path 7 (c): follower ids differ at batch {b}")
        leg.run([rec], PERSIST_FOLLOW_BATCHES)
        lag_before = rec._wal.last_seq - fol._applied_seq
        t0 = time.perf_counter()
        c2 = durability.catch_up(fol, src)
        torch.cuda.synchronize()
        c2_s = time.perf_counter() - t0
        check(c2.lag_seq == 0 and same_store(torch, fol.store, rec.store),
              "path 7 (c): the second catch_up left the follower behind")
        refused = False
        try:
            fol.upsert(ids[:1], vecs[:1])
        except durability.ReplicationError:
            refused = True
        check(refused, "path 7 (c): the follower took a local write")
        out["follower"] = {
            "seed_s": seed_s,
            "catch_up": [{"records": c1.records, "s": c1_s,
                          "lag_seq": c1.lag_seq},
                         {"records": c2.records, "s": c2_s,
                          "lag_before": lag_before, "lag_seq": c2.lag_seq}]}
        log(f"[path 7] (c) follower seeded in {seed_s:.2f} s; catch_up "
            f"{c1.records} records in {c1_s:.3f} s (lag {c1.lag_seq}), "
            f"store bit-equal to the primary's; {PERSIST_FOLLOW_BATCHES} "
            f"more batches (lag {lag_before}), catch_up {c2.records} "
            f"records in {c2_s:.3f} s (lag {c2.lag_seq}); a local write "
            "raised ReplicationError")
        fol_frozen = rec.frozen
        rec.close()
        del fol, rec

        # (d) WAL rates: host and disk numbers
        out["wal_rates"] = wal_rates(
            torch, (SearchEngine, StreamConfig, segments, DurabilityConfig,
                    Wal, wal_mod, fol_frozen, cfg), xd, root, SEED + 8)
        out["wal_rates"]["durable_batch_full_engine_rows_per_s"] = \
            out["durable"]["upsert_rows_per_s"]["durable"]
        out["wal_rates"]["note"] = (
            "host and disk numbers (the card takes no part in the WAL); "
            f"filesystem {out['disk']['filesystem']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["k1_cells_launches"] = k1_path7
    out["wall_s"] = time.perf_counter() - wall0
    log(f"[path 7] wall time {out['wall_s']:.1f} s")
    return out, k1_path7


# path 8: observability on path 1's engine. The traced engine's knobs;
# (d) a streaming engine of path 6's mix; (e) searches on another thread
# while the phase scrapes; (g) alternating overhead rounds
OBS_TRACE = dict(histograms=True, deep_trace_every=4, recall_every=4,
                 slow_query_ms=0.0)
OBS_REPEAT = 4                   # traced searches a batch in (a)
OBS_DEEP = 5                     # deep traces timed a batch in (b)
OBS_STREAM_BATCHES = 24          # write batches in (d): 2 compactions
OBS_SERVER_SEARCHES, OBS_SERVER_BATCH = 200, 64
OBS_ROUNDS, OBS_PER_ROUND = 20, 10   # (g): rounds x searches a variant
_PROM_SAMPLE = None


def prometheus_lint(text):
    """The exposition checks of a scrape: every line a TYPE line or a
    well-formed sample, one TYPE line for each family and before its
    samples, each histogram's buckets cumulative to +Inf equal to its
    _count, and ``qpad_engine_info{...}`` the last line. Returns the
    families' kinds."""
    import re
    global _PROM_SAMPLE
    if _PROM_SAMPLE is None:
        _PROM_SAMPLE = re.compile(
            r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*='
            r'"(?:[^"\\]|\\.)*"(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*'
            r'\})? -?(\d+\.?\d*([eE][+-]?\d+)?|[+-]?Inf|NaN)$')
    lines = text.splitlines()
    typed, hist = {}, {}
    for ln in lines:
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ")
            check(name not in typed, f"scrape: two TYPE lines for {name}")
            typed[name] = kind
            continue
        check(_PROM_SAMPLE.match(ln) is not None,
              f"scrape: malformed line {ln!r}")
        name = re.split(r"[{ ]", ln, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if typed.get(base) == "histogram":
            h = hist.setdefault(base, {"buckets": [], "count": None})
            val = float(ln.rsplit(" ", 1)[1])
            if name.endswith("_bucket"):
                h["buckets"].append(val)
            elif name.endswith("_count"):
                h["count"] = val
        else:
            check(name in typed, f"scrape: sample before its TYPE: {ln!r}")
    for base, h in hist.items():
        check(h["buckets"] == sorted(h["buckets"]) and h["buckets"]
              and h["buckets"][-1] == h["count"],
              f"scrape: histogram {base} not cumulative to its _count")
    check(lines and lines[-1].startswith("qpad_engine_info{"),
          "scrape: qpad_engine_info is not the last line")
    return typed


def observe_path(torch, mods, eng, xd, qd):
    """Path 8: observability on path 1's engine (module docstring, phase
    29). Returns (result dict, K1 cell-major launches, K3 launches)."""
    (ops, knn_topk, knn, SearchEngine, StreamConfig, segments, recall_at_k,
     tracing, MetricsServer, render_prometheus) = mods
    import urllib.request
    wall0 = time.perf_counter()
    out = {"spec": SPEC, "trace": dict(OBS_TRACE)}
    root = os.path.join(HERE, "build", "path8_traces")   # gitignored
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    k1, k3 = ops.pq_adc_cells_topk, knn_topk.knn_topk_d2
    cfg = eng.config
    kw = dict(nprobe=cfg.nprobe, rerank=cfg.rerank, backend=cfg.pq_backend,
              lut_dtype=cfg.lut_dtype, scan_cap=0, prefilter=0)
    k1_path8 = k3_path8 = 0      # K3: the shadow checks' launches
    try:
        # the phase's own K3 truth over the 1M rows, a call a batch (the
        # shadow check's own inputs: the bucket is the batch here)
        truth = {b: knn.knn_scan(qd[:b], xd, K)[1] for b in BATCHES}
        torch.cuda.synchronize()

        # (a) a traced and an untraced engine over one state: bit-equal
        # answers, compile_count moving together
        plain = SearchEngine.from_state(eng.state, cfg)
        traced = SearchEngine.from_state(eng.state, cfg).tracing(
            trace_dir=root, **OBS_TRACE)
        ops.pq_adc_gather_topk.launches = k1.launches = k3.launches = 0
        recall_checks = {}
        for b in BATCHES:
            for r in range(OBS_REPEAT):
                d0, i0 = plain.search(qd[:b], K)
                samples = traced.tracer.recall_samples
                d1, i1 = traced.search(qd[:b], K)
                check(torch.equal(i0, i1) and torch.equal(d0, d1),
                      f"path 8 (a): traced answers differ at batch {b}")
                check(traced.compile_count == plain.compile_count,
                      f"path 8 (a): compile_count {traced.compile_count} "
                      f"traced, {plain.compile_count} untraced")
                if traced.tracer.recall_samples > samples:
                    # (c) this search was shadow-checked: its recall
                    # against the phase's truth
                    want = recall_at_k(i1, truth[b])
                    got = traced.tracer.recall_last
                    check(got == want, f"path 8 (c): shadow recall {got} "
                          f"at batch {b}, {want} against the phase's K3 "
                          "truth")
                    recall_checks[b] = got
        torch.cuda.synchronize()
        tr = traced.tracer
        k1_a, k3_a = k1.launches, k3.launches
        k3_path8 += k3_a
        n_search = len(BATCHES) * OBS_REPEAT
        # the two engines' searches, then the deep traces' warm and timed
        # passes (a warm pass at each new batch)
        check(k1_a == 2 * n_search + tr.deep_traces + len(BATCHES)
              and ops.pq_adc_gather_topk.launches == 0,
              f"path 8 (a): K1's cell-major entry launched {k1_a} times "
              f"(gathered {ops.pq_adc_gather_topk.launches}) for "
              f"{2 * n_search} searches and {tr.deep_traces} deep traces")
        check(k3_a == tr.recall_samples == len(BATCHES),
              f"path 8 (c): K3 launched {k3_a} times for "
              f"{tr.recall_samples} shadow samples")
        check(sorted(recall_checks) == list(BATCHES),
              "path 8 (c): a batch was not shadow-checked")
        out["a"] = {"searches_per_engine": n_search, "bit_equal": True,
                    "compile_count": traced.compile_count,
                    "k1_cells_launches": k1_a, "k3_launches": k3_a,
                    "deep_traces": tr.deep_traces}
        out["c"] = {"recall_last_by_batch": recall_checks,
                    "recall_estimate_at_k": tr.recall_ema,
                    "shadow_samples": tr.recall_samples,
                    "k3_launches": k3_a}
        log(f"[path 8] (a) traced and untraced engines: ids and distances "
            f"bit-equal over {n_search} searches each at batches "
            f"{BATCHES}, compile_count {traced.compile_count} on both; K1 "
            f"cell-major {k1_a} launches, {tr.deep_traces} deep traces")
        log(f"[path 8] (c) shadow recall {recall_checks} equal to "
            f"recall_at_k against the phase's K3 truth; K3 {k3_a} launches "
            f"for {tr.recall_samples} samples")

        # (b) the deep trace at batches 1 and 256 (warm: the tracer ran
        # one at each batch)
        deep = {}
        for b in (1, 256):
            runs = []
            for _ in range(OBS_DEEP):
                c0, g0 = k1.launches, ops.pq_adc_gather_topk.launches
                t = tracing.deep_trace(traced, qd[:b], K, kw)
                check(k1.launches - c0 == 1 and
                      ops.pq_adc_gather_topk.launches == g0,
                      f"path 8 (b): the deep trace's scan at batch {b} "
                      f"launched K1's cell-major entry "
                      f"{k1.launches - c0} times")
                names = [n for n, _ in t["stages"]]
                check(names == ["project", "probe", "scan", "rerank"],
                      f"path 8 (b): stages {names}")
                total = sum(ms for _, ms in t["stages"])
                check(abs(total - t["e2e_ms"]) <= 0.10 * t["e2e_ms"],
                      f"path 8 (b): stages sum to {total} ms of "
                      f"{t['e2e_ms']} at batch {b}")
                runs.append(t)
            deep[b] = {
                "stages_ms_p50": {n: float(np.median(
                    [dict(t["stages"])[n] for t in runs])) for n in names},
                "e2e_ms_p50": float(np.median([t["e2e_ms"] for t in runs])),
                "sum_over_e2e": [sum(ms for _, ms in t["stages"])
                                 / t["e2e_ms"] for t in runs]}
            p50 = {n: round(v, 4) for n, v in
                   deep[b]["stages_ms_p50"].items()}
            log(f"[path 8] (b) deep trace at batch {b}: stages (ms, p50 of "
                f"{OBS_DEEP}) {p50}, e2e {deep[b]['e2e_ms_p50']:.4f} ms; K1 "
                "once a trace")
        out["b"] = deep

        # (d) a streaming engine of path 6's mix
        scfg = dataclasses.replace(cfg, stream=StreamConfig(
            delta_capacity=STREAM_DELTA))
        s_eng = SearchEngine.from_state(eng.state, scfg)
        leg = WriteLeg(torch, xd, SEED + 9, N)
        leg.run([s_eng], OBS_STREAM_BATCHES)
        s_eng.tracing(recall_every=1)
        k0 = k3.launches
        _, ids = s_eng.search(qd[:STREAM_Q], K)
        torch.cuda.synchronize()
        k3_path8 += k3.launches - k0
        check(k3.launches - k0 == 1, "path 8 (d): the streaming shadow "
              f"check launched K3 {k3.launches - k0} times")
        m = s_eng.metrics()
        check(m.stream is not None and m.compact is not None
              and m.policy is not None, "path 8 (d): a streaming section "
              "is missing")
        dead = int(s_eng.store.dead.sum())
        check(m.stream.tombstones == dead, f"path 8 (d): stream.tombstones "
              f"{m.stream.tombstones}, the store holds {dead}")
        check(m.compact.compactions == s_eng.counters["compactions"] >= 1,
              f"path 8 (d): compact.compactions {m.compact.compactions}, "
              f"the engine counted {s_eng.counters['compactions']}")
        vecs, ext = live_rows(torch, segments, s_eng.store)
        k0 = k3.launches
        _, idx = knn.knn_scan(qd[:STREAM_Q], vecs, K)   # the check's own
        #                                 truth: not in k3_path8
        want = recall_at_k(ids, ext[idx])
        check(m.recall.last == want, f"path 8 (d): shadow recall "
              f"{m.recall.last}, {want} over the survivors")
        check(not bool(torch.isin(ids, leg.deleted).any()),
              "path 8 (d): a deleted id came back")
        flat = m.flatten()
        out["d"] = {k: flat[k] for k in sorted(flat)
                    if k.startswith(("stream.", "compact.", "policy.",
                                     "recall."))}
        out["d"]["write_batches"] = OBS_STREAM_BATCHES
        log(f"[path 8] (d) streaming engine after {OBS_STREAM_BATCHES} "
            f"write batches: tombstones {m.stream.tombstones} (store "
            f"{dead}), compactions {m.compact.compactions}, rows "
            f"{m.stream.rows}, delta {m.stream.delta_used}; shadow recall "
            f"{m.recall.last:.4f} = recall over the survivors (K3)")
        text = render_prometheus(m)
        prometheus_lint(text)
        del s_eng, vecs, ext
        torch.cuda.empty_cache()

        # (e) scrapes from this thread while another searches
        errors, scrapes = [], []
        k0 = k3.launches
        s0 = traced.tracer.recall_samples
        q64 = qd[:OBS_SERVER_BATCH]

        def searcher():
            try:
                for _ in range(OBS_SERVER_SEARCHES):
                    traced.search(q64, K)
            except Exception as e:          # surfaced below
                errors.append(e)

        with MetricsServer(traced, port=0) as srv:
            th = threading.Thread(target=searcher, name="path8-searches")
            t0 = time.perf_counter()
            th.start()
            while th.is_alive() or not scrapes:
                with urllib.request.urlopen(srv.url, timeout=30) as r:
                    check(r.status == 200, f"path 8 (e): scrape {r.status}")
                    body = r.read().decode()
                prometheus_lint(body)
                scrapes.append(body)
                time.sleep(0.005)           # a scraper's pace, not a spin
            th.join()
            e_s = time.perf_counter() - t0
            with urllib.request.urlopen(srv.url.replace(
                    "/metrics", "/metrics.json"), timeout=30) as r:
                doc = json.loads(r.read().decode())
        torch.cuda.synchronize()
        check(not errors, f"path 8 (e): the search thread raised {errors}")
        k3_e = k3.launches - k0
        k3_path8 += k3_e
        check(k3_e == traced.tracer.recall_samples - s0,
              f"path 8 (e): K3 launched {k3_e} times for "
              f"{traced.tracer.recall_samples - s0} shadow samples")
        check(doc["latency.queries"] == traced.tracer.queries,
              "path 8 (e): the JSON scrape's latency.queries")
        out["e"] = {"searches": OBS_SERVER_SEARCHES,
                    "batch": OBS_SERVER_BATCH, "scrapes": len(scrapes),
                    "families": len(prometheus_lint(scrapes[-1])),
                    "s": e_s, "scrape_lines": len(scrapes[-1].splitlines()),
                    "latency_search_p50_ms": doc["latency.search.p50"],
                    "k3_launches": k3_e}
        log(f"[path 8] (e) {len(scrapes)} scrapes while {OBS_SERVER_SEARCHES}"
            f" traced searches at batch {OBS_SERVER_BATCH} ran on another "
            f"thread ({e_s:.2f} s): every one parsed, "
            f"{out['e']['families']} families, qpad_engine_info last")

        # (f) the Chrome trace and a torch.profiler trace
        path = traced.flush_trace()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        n_search = sum(e["name"] == "search" for e in events)
        check(n_search == traced.tracer.queries,
              f"path 8 (f): {n_search} search events for "
              f"{traced.tracer.queries} traced searches")
        check(sum(e["name"].startswith("deep.") for e in events)
              == 4 * traced.tracer.deep_traces, "path 8 (f): deep events")
        prof_hits = None
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            pdir = os.path.join(root, f"profile_{attempt}")
            with tracing.torch_profile(pdir):
                for _ in range(5):
                    plain.search(qd, K)
            with open(os.path.join(pdir, f"qpad_profile_{os.getpid()}"
                                   ".json")) as f:
                pev = json.load(f)["traceEvents"]
            prof_hits = sum(1 for e in pev if e.get("cat") == "kernel"
                            and "adc_select<" in e.get("name", ""))
            if prof_hits:
                break
            TRACE_LOSSES.append({"label": "path 8 torch_profile",
                                 "attempt": attempt, "lost": {
                                     "adc_select<": {"launched": 5,
                                                     "traced": 0}},
                                 "used": False})
        check(prof_hits, "path 8 (f): torch_profile's trace holds no K1 "
              "kernel record")
        out["f"] = {"chrome_trace_events": len(events),
                    "search_events": n_search,
                    "profile_k1_records": prof_hits,
                    "profile_events": len(pev)}
        log(f"[path 8] (f) flush_trace: {len(events)} events load; "
            f"torch_profile: {len(pev)} events, {prof_hits} K1 kernel "
            "records")

        # (g) the overhead of histograms-only tracing and of an attached
        # but inactive tracer: alternating rounds in this one call
        hist_only = SearchEngine.from_state(eng.state, cfg).tracing()
        inactive = SearchEngine.from_state(eng.state, cfg).tracing(
            histograms=False)
        variants = {"untraced": plain, "histograms": hist_only,
                    "inactive": inactive}
        over = {}
        for b in (1, 256):
            qb = qd[:b]
            for e in variants.values():
                for _ in range(3):
                    e.search(qb, K)
            times = {v: [] for v in variants}
            order = list(variants)
            for r in range(OBS_ROUNDS):
                for v in order[r % 3:] + order[:r % 3]:
                    e = variants[v]
                    for _ in range(OBS_PER_ROUND):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        e.search(qb, K)
                        torch.cuda.synchronize()
                        times[v].append((time.perf_counter() - t0) * 1e3)
            p50 = {v: float(np.median(t)) for v, t in times.items()}
            over[b] = {"p50_ms": p50,
                       "histograms_overhead": p50["histograms"]
                       / p50["untraced"] - 1.0,
                       "inactive_overhead": p50["inactive"]
                       / p50["untraced"] - 1.0,
                       "samples": OBS_ROUNDS * OBS_PER_ROUND}
            log(f"[path 8] (g) batch {b}: p50 untraced "
                f"{p50['untraced']:.4f} ms, histograms "
                f"{p50['histograms']:.4f} "
                f"({100 * over[b]['histograms_overhead']:+.2f}%), inactive "
                f"tracer {p50['inactive']:.4f} "
                f"({100 * over[b]['inactive_overhead']:+.2f}%); "
                f"{OBS_ROUNDS} alternating rounds of {OBS_PER_ROUND}")
        torch.cuda.synchronize()
        out["g"] = over
        # every K1 launch since the counts were zeroed: the searches, the
        # deep traces, the streaming search, the profiled searches
        k1_path8 = k1.launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["k1_cells_launches"] = k1_path8
    out["k3_launches"] = k3_path8
    out["wall_s"] = time.perf_counter() - wall0
    log(f"[path 8] K1 cell-major {k1_path8} launches, K3 {k3_path8}; wall "
        f"time {out['wall_s']:.1f} s")
    return out, k1_path8, k3_path8


def shard_writes(torch, xd, seed):
    """``SHARD_WRITE_BATCHES`` batches of path 6's write mix as host
    arrays: ``STREAM_NEW`` new ids and ``STREAM_OVERWRITE`` base
    overwrites a batch (rows near existing ones), and from the second
    batch on ``STREAM_DELETE`` of the previous batch's new ids deleted."""
    rng = np.random.default_rng(seed)
    overwrite = rng.choice(N, SHARD_WRITE_BATCHES * STREAM_OVERWRITE,
                           replace=False)
    out, prev = [], None
    for bi in range(SHARD_WRITE_BATCHES):
        new = np.arange(N + bi * STREAM_NEW, N + (bi + 1) * STREAM_NEW)
        ow = overwrite[bi * STREAM_OVERWRITE:(bi + 1) * STREAM_OVERWRITE]
        src = np.concatenate([rng.integers(0, N, STREAM_NEW), ow])
        vecs = (xd[torch.from_numpy(src).to(xd.device)].cpu().numpy()
                + STREAM_NOISE * rng.standard_normal(
                    (src.shape[0], DIM)).astype(np.float32))
        gone = (None if prev is None
                else rng.permutation(prev)[:STREAM_DELETE])
        out.append((np.concatenate([new, ow]), vecs.astype(np.float32),
                    gone))
        prev = new
    return out


def apply_writes(eng, batch):
    ids, vecs, gone = batch
    eng.upsert(ids, vecs)
    if gone is not None:
        eng.delete(gone)


def events_ms(torch, fn, reps=SHARD_REPS, warmup=2):
    """p50 of ``reps`` calls timed by CUDA events (``warmup`` calls
    first)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phi_steps(torch, phi_vg, xs, w0):
    """Three steps of the greedy fit's objective on ``xs`` (a rank's rows
    for the distributed one): w0[j] against the penalty of w0[:j]
    (normalized), at path 2's b and alpha. Returns [(value, grad)] on the
    host."""
    m, dim = w0.shape
    prev = torch.zeros((m, dim), device=xs.device)
    mask = torch.zeros(m, device=xs.device)
    out = []
    for j in range(3):
        w = w0[j]
        v, g = phi_vg(w, xs, prev, mask, b=FIT["b"], alpha=FIT["alpha"])
        out.append((float(v), g.cpu().numpy()))
        prev[j] = w / w.norm()
        mask[j] = 1.0
    return out


def shard_rank(mesh, snap_dir, pq_dir, queries, writes, fit_in, timed):
    """One gloo rank of path 9 (b) / (c) on the one card: path 1's
    snapshot restored onto the mesh and searched at every batch (with
    ``pq_dir``, path 2's pq snapshot too: K2's global entry with pad rows
    live); a streaming engine restored, sharded and searched after each
    write batch; with ``timed`` the p50s, with ``fit_in`` the sharded MPAD
    fit at JAX's test's configuration and ``make_phi_dist``'s first steps
    at path 2's m 64. Returns host data (rank 0's is what the parent
    checks), with whether every rank returned the same ids."""
    import torch
    from repro_torch.core import MPADConfig
    from repro_torch.core.distributed import fit_mpad_sharded, make_phi_dist
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.parallel import all_gather
    from repro_torch.search import StreamConfig, load_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    qd = torch.from_numpy(queries).to(mesh.device)
    out = {"rank_device": str(mesh.device), "same_on_every_rank": True}

    def same(i):
        every = all_gather(mesh, i[None], dim=0)
        out["same_on_every_rank"] &= bool((every == i).all())

    t0 = time.perf_counter()
    eng = load_engine(snap_dir, mesh=mesh)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["rows_on_rank"] = int(eng.sharded_state.corpus.shape[0])
    ops.pq_adc_cells_topk.launches = 0
    out["ids"] = {}
    for b in BATCHES:
        _, i = eng.search(qd[:b], K)
        same(i)
        out["ids"][b] = i.cpu().numpy()
    out["k1_cells_launches"] = ops.pq_adc_cells_topk.launches
    if timed:
        out["p50_ms"] = {b: events_ms(torch,
                                      lambda b=b: eng.search(qd[:b], K))
                         for b in (1, 256)}
    del eng
    torch.cuda.empty_cache()
    if pq_dir is not None:
        eng = load_engine(pq_dir, mesh=mesh)
        ops.pq_adc_topk_global.launches = 0
        out["pq_ids"] = {}
        for b in BATCHES:
            _, i = eng.search(qd[:b], K)
            same(i)
            out["pq_ids"][b] = i.cpu().numpy()
        out["k2_global_launches"] = ops.pq_adc_topk_global.launches
        del eng
        torch.cuda.empty_cache()
    s_eng = load_engine(snap_dir, device=mesh.device).streaming(
        StreamConfig(delta_capacity=STREAM_DELTA))
    s_eng.shard(mesh)
    out["stream_ids"] = []
    for batch in writes:
        apply_writes(s_eng, batch)
        _, i = s_eng.search(qd, K)
        same(i)
        out["stream_ids"].append(i.cpu().numpy())
    if timed:
        out["stream_p50_ms"] = events_ms(torch, lambda: s_eng.search(qd, K))
    del s_eng
    torch.cuda.empty_cache()
    if fit_in is not None:
        sample, w0 = fit_in
        cfg = SHARD_FIT_JAX_TEST
        t0 = time.perf_counter()
        res = fit_mpad_sharded(torch.from_numpy(sample), MPADConfig(**cfg),
                               mesh, w0=torch.from_numpy(w0[:cfg["m"]]))
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["fit"] = (res.matrix.cpu().numpy(),
                      res.objective_trace[:, -1].cpu().numpy())
        x = torch.from_numpy(sample).to(mesh.device)
        per = x.shape[0] // mesh.size
        xs_loc = (x - x.mean(dim=0))[mesh.rank * per:(mesh.rank + 1) * per]
        out["phi_steps"] = phi_steps(
            torch, make_phi_dist(mesh, x.shape[0]), xs_loc,
            torch.from_numpy(w0).to(mesh.device))
    return out


def k2_global_blocks(torch, ops, tables, codes, shards, slack):
    """K2's global entry at the main path's shapes: path 2's (N, M) codes
    padded to a multiple of ``shards`` (zero codes, as the layout pads)
    and cut into the ranks' row blocks, each scanned at ``RERANK`` with
    its real ``row_offset``, ``n_valid`` N and ``slack``, against
    ``pq_adc_topk_global_plain`` on the same inputs: d2 and ids
    bit-equal (the kernel is bit-equal to its plain version, and both
    take the same global-id steps), every id a real row of its block.
    The blocks merged in rank order (a stable sort: ties to the lower
    rank, then the lower row) must give the unsharded K2's ids. Returns
    (max |err|, pad rows in the last block)."""
    n = codes.shape[0]
    pad = (-n) % shards
    padded = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    per = padded.shape[0] // shards
    err, parts = 0.0, []
    for r in range(shards):
        block = padded[r * per:(r + 1) * per]
        dk, ik = ops.pq_adc_topk_global(tables, block, RERANK,
                                        row_offset=r * per, n_valid=n,
                                        slack=slack, lut_dtype="int8")
        torch.cuda.synchronize()
        dp, ip = ops.pq_adc_topk_global_plain(tables, block, RERANK,
                                              r * per, n, slack, "int8")
        fin = torch.isfinite(dp)
        check(torch.equal(torch.isfinite(dk), fin),
              f"K2 global block {r}: finite mask")
        e = float((dk[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
        err = max(err, e)
        check(torch.equal(dk, dp),
              f"K2 global block {r}: d2 not bit-equal (max err {e})")
        check(torch.equal(ik, ip), f"K2 global block {r}: ids differ")
        check(bool(((ik >= r * per) & (ik < min(n, (r + 1) * per))).all()),
              f"K2 global block {r}: an id outside the block's real rows")
        parts.append((dk, ik))
    d = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :RERANK]
    _, want = ops.pq_adc_topk(tables, codes, RERANK, "int8")
    check(torch.equal(torch.gather(i, 1, order), want),
          "K2 global: the blocks merged in rank order differ from the "
          "unsharded K2's ids")
    return err, pad


def shard_path(torch, mods, eng, eng_pq, k2_in, xd, qd, counters, smi):
    """Path 9: sharded serving on the one card (module docstring, phase
    30). (a) a world of 1 over NCCL in this process: path 1's ivfpq
    engine (K1), path 2's pq engine (K2's global entry) and a flat
    ``pca64>rr64`` engine (K3 over the rank's rows) sharded, ids equal to
    the unsharded engine's at every batch, distances within 1e-5, p50s at
    1 and 256, each kernel's launches on the sharded route; then K2's
    global entry over 3 row blocks of path 2's codes against its plain
    version (``k2_global_blocks``). (b) worlds of 2 and 3 gloo ranks on
    ``cuda:0`` (pad rows and pad cells live): path 1's snapshot restored
    onto the mesh, rank 0's ids equal the unsharded engine's at every
    batch (world 3 restores path 2's pq snapshot too), then a streaming
    sharded engine through 8 write batches, ids equal the unsharded
    streaming engine's after each. (c) ``fit_mpad_sharded`` at world 1
    (NCCL) and 2 (gloo) on path 1's fit sample against ``fit_mpad``
    (fast) at JAX's test's configuration (m 3, iters 16), matrix within
    0.05; and at path 2's m 64, ``make_phi_dist``'s first three steps at
    world 1 and 2 against ``phi_fast_value_and_grad`` on the whole
    sample (value rtol 1e-5, gradient rtol 1e-3 / atol 1e-5). The m-64
    fits themselves are ``--fit-spread``'s. The world-3 ranks run alone
    on the card and are timed; the world-2 ranks run beside this
    process's fits, untimed."""
    (ops, knn_topk, SearchEngine, build_engine, StreamConfig, MPADConfig,
     fit_mpad, fit_mpad_sharded, make_serving_mesh, run_ranks,
     cpu_generator, fast_objective, make_phi_dist) = mods
    import torch.distributed as dist
    dev = xd.device
    t_path = time.perf_counter()
    out = {"card": smi, "gloo_worlds": list(SHARD_GLOO_WORLDS)}
    root = os.path.join(HERE, "chiprun_out", "path9_snapshot")
    root_pq = os.path.join(HERE, "chiprun_out", "path9_snapshot_pq")
    for d in (root, root_pq):
        if os.path.isdir(d):
            shutil.rmtree(d)
    box = {}
    try:
        t0 = time.perf_counter()
        eng.save(root)
        out["snapshot_s"] = time.perf_counter() - t0
        eng_pq.save(root_pq)
        queries = qd.cpu().numpy()
        writes = shard_writes(torch, xd, SEED + 9)
        gen = cpu_generator(SEED)
        rows = torch.randperm(N, generator=gen)[:FIT_SAMPLE].to(dev)
        sample = xd[rows].cpu().numpy()
        w0 = np.random.default_rng(SEED + 9).standard_normal(
            (FIT["m"], DIM)).astype(np.float32)

        # the unsharded streaming engine the gloo ranks must equal
        s_eng = SearchEngine.from_state(eng.state, dataclasses.replace(
            eng.config, stream=StreamConfig(delta_capacity=STREAM_DELTA)))
        want_stream = []
        for batch in writes:
            apply_writes(s_eng, batch)
            want_stream.append(s_eng.search(qd, K)[1].cpu().numpy())
        del s_eng
        torch.cuda.empty_cache()

        # (a) a world of 1 over NCCL
        mesh = make_serving_mesh(1, backend="nccl")
        flat = build_engine(xd, SPEC_FLAT, device=dev, seed=SEED)
        a = {}
        unsharded_ids = {}
        for name, e in (("ivfpq", eng), ("pq", eng_pq), ("flat", flat)):
            lat0, found0 = search_timed(torch, e, qd, BATCHES)
            d0 = {b: e.search(qd[:b], K)[0] for b in BATCHES}
            se = SearchEngine.from_state(e.state, e.config).shard(mesh)
            for fn in counters:
                fn.launches = 0
            ops.pq_adc_topk_global.launches = 0
            lat1, found1 = search_timed(torch, se, qd, BATCHES)
            torch.cuda.synchronize()
            launches = {"k1_cells": ops.pq_adc_cells_topk.launches,
                        "k1_gathered": ops.pq_adc_gather_topk.launches,
                        "k2": ops.pq_adc_topk.launches,
                        "k2_global": ops.pq_adc_topk_global.launches,
                        "k3": knn_topk.knn_topk_d2.launches}
            for b in BATCHES:
                check(torch.equal(found1[b], found0[b]),
                      f"path 9 (a) {name}: sharded ids differ at batch {b}")
                d1 = se.search(qd[:b], K)[0]
                err = float((d1 - d0[b]).abs().max())
                check(err <= 1e-5, f"path 9 (a) {name}: distances differ "
                      f"by {err} at batch {b}")
            unsharded_ids[name] = {b: found0[b].cpu().numpy()
                                   for b in BATCHES}
            a[name] = {"p50_ms": {b: lat0[b]["p50_ms"] for b in BATCHES},
                       "sharded_p50_ms": {b: lat1[b]["p50_ms"]
                                          for b in BATCHES},
                       "launches": launches}
            log(f"[path 9] (a) {name} world 1 NCCL: ids equal at batches "
                f"{BATCHES}; p50 batch 1 {lat0[1]['p50_ms']:.3f} ms "
                f"unsharded / {lat1[1]['p50_ms']:.3f} ms sharded, batch 256 "
                f"{lat0[256]['p50_ms']:.3f} / {lat1[256]['p50_ms']:.3f} ms; "
                f"launches on the sharded route {launches} ({smi})")
            del se
        check(a["ivfpq"]["launches"]["k1_cells"] > 0
              and a["ivfpq"]["launches"]["k1_gathered"] == 0,
              "path 9 (a): the sharded ivfpq route did not run K1's "
              "cell-major entry alone")
        check(a["pq"]["launches"]["k2_global"] > 0
              and a["pq"]["launches"]["k2"] == a["pq"]["launches"][
                  "k2_global"],
              "path 9 (a): the sharded pq route did not run K2's global "
              "entry")
        check(a["flat"]["launches"]["k3"] > 0,
              "path 9 (a): the sharded flat route did not run K3")
        out["a"] = a
        # K2's global entry held against its plain version at path 2's
        # shapes, pad rows live (these launches are not the path's)
        t0 = time.perf_counter()
        k2g_err, k2g_pad = k2_global_blocks(torch, ops, *k2_in,
                                            shards=3, slack=2)
        out["k2_global_check"] = {
            "shards": 3, "slack": 2, "pad_rows": k2g_pad, "k": RERANK,
            "queries": int(k2_in[0].shape[0]), "max_abs_err": k2g_err,
            "s": time.perf_counter() - t0}
        log(f"[path 9] K2 global entry over 3 blocks of path 2's {N} codes "
            f"({k2g_pad} pad rows, slack 2, k {RERANK}, int8): bit-equal to "
            f"its plain version, merged ids equal the unsharded K2's")
        del flat
        torch.cuda.empty_cache()

        # (b) a world of 3 gloo ranks, timed, alone on the card
        box[3] = run_ranks(shard_rank, 3,
                           (root, root_pq, queries, writes, None, True),
                           backend="gloo", device="cuda:0", timeout=900)

        # (b) a world of 2, and its sharded fit (c), while this process
        # runs the world-1 fit and the reference fit (untimed searches)
        def world2():
            try:
                box[2] = run_ranks(shard_rank, 2,
                                   (root, None, queries, writes,
                                    (sample, w0), False),
                                   backend="gloo", device="cuda:0",
                                   timeout=900)
            except BaseException as exc:        # re-raised below
                box["error"] = exc

        worker = threading.Thread(target=world2, name="path9-world2")
        worker.start()
        fits, fit_s = {}, {}

        def timed_fit(name, fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            fit_s[name] = time.perf_counter() - t0
            fits[name] = (res.matrix.cpu().numpy(),
                          res.objective_trace[:, -1].cpu().numpy())

        try:
            cfg = SHARD_FIT_JAX_TEST
            w0c = torch.from_numpy(w0[:cfg["m"]])
            timed_fit("fit_mpad", lambda: fit_mpad(
                torch.from_numpy(sample), MPADConfig(**cfg), w0=w0c,
                device=dev))
            timed_fit("world1", lambda: fit_mpad_sharded(
                torch.from_numpy(sample), MPADConfig(**cfg), mesh, w0=w0c))
            x = torch.from_numpy(sample).to(dev)
            xs = x - x.mean(dim=0)
            w0d = torch.from_numpy(w0).to(dev)
            steps = {"single": phi_steps(
                torch, fast_objective.phi_fast_value_and_grad, xs, w0d),
                "world1": phi_steps(torch, make_phi_dist(mesh, FIT_SAMPLE),
                                    xs, w0d)}
        finally:
            worker.join()
        if "error" in box:
            raise box["error"]
        dist.destroy_process_group()
        b_out = {}
        for world in SHARD_GLOO_WORLDS:
            r = box[world]
            check(r["same_on_every_rank"],
                  f"path 9 (b) world {world}: the ranks' ids differ")
            for b in BATCHES:
                check(np.array_equal(r["ids"][b], unsharded_ids["ivfpq"][b]),
                      f"path 9 (b) world {world}: ids differ from the "
                      f"unsharded engine's at batch {b}")
            for bi, (got, want) in enumerate(zip(r["stream_ids"],
                                                 want_stream)):
                check(np.array_equal(got, want),
                      f"path 9 (b) world {world}: streaming ids differ "
                      f"after write batch {bi + 1}")
            check(r["k1_cells_launches"] > 0,
                  f"path 9 (b) world {world}: K1 never launched on rank 0")
            if "pq_ids" in r:
                for b in BATCHES:
                    check(np.array_equal(r["pq_ids"][b],
                                         unsharded_ids["pq"][b]),
                          f"path 9 (b) world {world}: pq ids differ from "
                          f"the unsharded engine's at batch {b}")
                check(r["k2_global_launches"] > 0,
                      f"path 9 (b) world {world}: K2's global entry never "
                      "launched on rank 0")
            b_out[world] = {k: r[k] for k in (
                "restore_s", "rows_on_rank", "p50_ms", "stream_p50_ms",
                "k1_cells_launches", "k2_global_launches") if k in r}
            timing = ("untimed: it ran beside this process's fits"
                      if "p50_ms" not in r else
                      f"rank 0 p50 batch 1 {r['p50_ms'][1]:.3f} ms, batch "
                      f"256 {r['p50_ms'][256]:.3f} ms, streaming 256 "
                      f"{r['stream_p50_ms']:.3f} ms")
            log(f"[path 9] (b) world {world} gloo on one card "
                f"(host-staged collectives, not a deployment's numbers): "
                f"ids equal at batches {BATCHES}"
                f"{' (ivfpq and pq)' if 'pq_ids' in r else ''} and after "
                f"each of "
                f"{len(writes)} write batches; {timing} ({smi})")
        out["b"] = b_out
        fits["world2"] = box[2]["fit"]
        fit_s["world2"] = box[2]["fit_s"]
        steps["world2"] = box[2]["phi_steps"]
        ref_m, ref_phi = fits["fit_mpad"]
        c = {"rows": FIT_SAMPLE, "config": SHARD_FIT_JAX_TEST, "s": fit_s,
             "card": smi, "fits": {}, "phi_steps_m64": {}}
        for name in ("world1", "world2"):
            got_m, got_phi = fits[name]
            err = float(np.abs(got_m - ref_m).max())
            c["fits"][name] = {
                "matrix_max_abs_diff": err,
                "phi_final_max_rel_diff": float(np.max(
                    np.abs(got_phi - ref_phi) / np.abs(ref_phi)))}
            check(err < 0.05, f"path 9 (c): the {name} fit is {err} from "
                  "fit_mpad")
        # make_phi_dist at path 2's m 64: the ranks' partial sums in
        # another order move a step's value and gradient by rounding only
        for name in ("world1", "world2"):
            rel, gerr = 0.0, 0.0
            for (vs, gs), (vd, gd) in zip(steps["single"], steps[name]):
                rel = max(rel, abs(vd - vs) / abs(vs))
                gerr = max(gerr, float(np.abs(gd - gs).max()))
                check(abs(vd - vs) <= 1e-5 * abs(vs),
                      f"path 9 (c): {name} phi value {vd} vs {vs}")
                check(np.allclose(gd, gs, rtol=1e-3, atol=1e-5),
                      f"path 9 (c): {name} phi gradient differs (max "
                      f"{float(np.abs(gd - gs).max())})")
            c["phi_steps_m64"][name] = {"value_max_rel_diff": rel,
                                        "grad_max_abs_diff": gerr}
        out["c"] = c
        log(f"[path 9] (c) fit_mpad_sharded against fit_mpad (fast), "
            f"{FIT_SAMPLE} rows, m {SHARD_FIT_JAX_TEST['m']} iters "
            f"{SHARD_FIT_JAX_TEST['iters']}: "
            + "; ".join(f"{k} max |d| {v['matrix_max_abs_diff']:.2e}"
                        for k, v in c["fits"].items())
            + "; make_phi_dist at m 64, 3 steps against the single-rank "
            "objective: "
            + "; ".join(f"{k} value rel {v['value_max_rel_diff']:.2e}, grad "
                        f"max |d| {v['grad_max_abs_diff']:.2e}"
                        for k, v in c["phi_steps_m64"].items())
            + f"; seconds {json.dumps({k: round(v, 2) for k, v in fit_s.items()})}"
            f" ({smi})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(root_pq, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_path
    launches = {"k1_cells": out["a"]["ivfpq"]["launches"]["k1_cells"],
                "k2_global": out["a"]["pq"]["launches"]["k2_global"],
                "k3": out["a"]["flat"]["launches"]["k3"]}
    log(f"[path 9] done in {out['wall_s']:.1f} s")
    return out, launches


def ivf_phase(torch, mods, xd, qd, truth, counters):
    """The ivf kind on path 1's corpus: build_engine(SPEC_IVF), searches at
    every batch (p50, QPS), recall@10 against exact search. The scan is a
    gather and a top-k: no kernel of the port runs in it."""
    build_engine, recall_at_k = mods
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = build_engine(xd, SPEC_IVF, device=xd.device, seed=SEED)
    torch.cuda.synchronize()
    out = {"spec": SPEC_IVF, "build_s": time.perf_counter() - t0,
           "build_stages_s": eng.build_seconds}
    for fn in counters:
        fn.launches = 0
    lat, found = search_timed(torch, eng, qd, BATCHES)
    check(all(fn.launches == 0 for fn in counters),
          "a kernel ran in the ivf engine's searches")
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    out.update(latency=lat, recall_at_10=rec)
    for b in BATCHES:
        log(f"[ivf] {SPEC_IVF} batch {b:4d}: p50 {lat[b]['p50_ms']:.3f} ms "
            f"qps {lat[b]['qps']:.0f} recall@10 {rec[b]:.4f}")
    log(f"[ivf] build {out['build_s']:.2f} s, stages "
        f"{ {k: round(v, 2) for k, v in eng.build_seconds.items()} }")
    check(rec[256] >= RECALL_FLOOR, f"ivf recall@10 {rec[256]}")
    return out


def prefilter_case(torch, SearchEngine, off, qd, small):
    """One pre-filter case: ``off`` (prefilter_batch 0) and an engine over
    its state with prefilter_batch=64, searched at ``small``; ids equal at
    every batch, the pre-filter run once a search of the second engine
    and never in the first. Returns (p50s without, p50s with, branch
    counts)."""
    on = SearchEngine.from_state(off.state, dataclasses.replace(
        off.config, prefilter_batch=64))
    lat_off, found_off = search_timed(torch, off, qd, small)
    lat_on, found_on = search_timed(torch, on, qd, small)
    calls = {b: on.counters[f"prefilter_{b}"] for b in ("tight", "full")}
    check(sum(calls.values()) == 22 * len(small)
          and off.counters["prefilter_tight"]
          + off.counters["prefilter_full"] == 0,
          f"the pre-filter ran {calls} times, not once a search")
    for b in small:
        check(torch.equal(found_on[b], found_off[b]),
              f"pre-filter: ids differ at batch {b}")
    return lat_off, lat_on, calls


def prefilter_phase(torch, mods, xd, qd):
    """The certified re-rank pre-filter on the first PREFILTER_ROWS rows
    (no Reduce stage), with prefilter_batch=64 and 0 over one state: ids
    equal at batches 1, 8 and 64, both p50s, and how often the narrow
    (tight) re-rank ran. SPEC_PREFILTER's int8 LUT bound keeps every
    candidate on this corpus, so its searches take the full branch;
    SPEC_PREFILTER_TIGHT (f32 LUT, so no LUT bound, and finer codes, so a
    smaller reconstruction error) must take the tight branch, whose
    compaction and narrow gather then hold the full re-rank's ids."""
    build_engine, SearchEngine = mods
    xc = xd[:PREFILTER_ROWS]
    small = (1, 8, 64)
    out = {"rows": PREFILTER_ROWS}
    for name, spec in (("int8", SPEC_PREFILTER),
                       ("tight", SPEC_PREFILTER_TIGHT)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = build_engine(xc, spec, device=xd.device, seed=SEED)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        lat_off, lat_on, calls = prefilter_case(torch, SearchEngine, off, qd,
                                                small)
        out[name] = {"spec": spec, "build_s": build_s,
                     "latency_off": lat_off, "latency_on": lat_on,
                     "branches": calls}
        for b in small:
            log(f"[pre-filter] {name} batch {b:3d}: p50 with "
                f"{lat_on[b]['p50_ms']:.3f} ms, without "
                f"{lat_off[b]['p50_ms']:.3f} ms; ids equal")
        log(f"[pre-filter] {spec} on {PREFILTER_ROWS} rows: branches taken "
            f"{calls} (tight: the narrow re-rank)")
        del off
    check(out["tight"]["branches"]["tight"] > 0,
          f"pre-filter: {SPEC_PREFILTER_TIGHT} never took the tight branch")
    return out


def moe_layer0(torch, tf, fa, rms_norm, chunked_attention, cfg, params,
               tokens, flash):
    """Layer 0 of ``tokens`` as the prefill runs it, up to its MoE input:
    (the normed residual after attention, (B * S, D); layer 0's q, k, v),
    the attention on K5 (``flash``) or on the chunked route."""
    lp0 = {key: t[0] for key, t in params["runs"][0].items() if key != "moe"}
    with torch.inference_mode():
        h = params["embed"][tokens].to(cfg.dtype)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        q, k, v = tf._qkv(cfg, rms_norm(h, lp0["ln1"]), lp0, pos, None)
        attn = (fa.flash_attention(q, k, v, None) if flash else
                chunked_attention(q, k, v, pos, pos, window=None,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk))
        h = h + attn.reshape(h.shape[0], h.shape[1], -1) @ lp0["wo"]
        return rms_norm(h, lp0["ln2"]).reshape(-1, cfg.d_model), (q, k, v)


def moe_block_checks(torch, moe, cfg, lp, x2d):
    """Path 10 (b) on layer 0's MoE parameters ``lp`` and its input x2d
    (T, D): dispatch at capacity_factor E / K (nothing dropped) against
    dense (the expert ids equal, each token row within MOE_ROW_REL); at the
    config's capacity_factor, the dropped (token, expert) assignments
    against a count over the expert ids made on the host; then the block's
    times (the configured impl at this T, its router, its dispatch tables,
    its expert matmuls alone; dense at the decode batch) by CUDA events."""
    import torch.nn.functional as F
    t, d = x2d.shape
    e, kk, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff
    nodrop = dataclasses.replace(cfg.moe, impl="dispatch",
                                 capacity_factor=e / kk)
    dense = dataclasses.replace(cfg.moe, impl="dense")
    out = {"tokens": t, "experts": e, "top_k": kk}
    with torch.inference_mode():
        y_disp, aux_disp = moe.moe_block(x2d[None], lp, nodrop)
        y_dense, aux_dense = moe.moe_block(x2d[None], lp, dense)
        _, topi_disp, _ = moe._route(x2d, lp["router"], nodrop)
        topv, topi, _ = moe._route(x2d, lp["router"], dense)
        cap = moe.capacity(t, nodrop)
        valid = moe._dispatch_tables(x2d, nodrop, topv, topi, cap)[2]
        check(bool(valid.all()), f"{cfg.name}: dispatch at capacity_factor "
              f"E / K dropped {int((~valid).sum())} assignments")
        check(torch.equal(topi_disp, topi), f"{cfg.name}: the expert ids "
              "differ between dispatch and dense")
        yd, yn = y_disp[0].float(), y_dense[0].float()
        row = (torch.linalg.vector_norm(yd - yn, dim=-1)
               / torch.linalg.vector_norm(yn, dim=-1).clamp_min(1e-30))
        out["dispatch_vs_dense"] = {
            "row_rel_max": float(row.max()), "row_rel_mean": float(row.mean()),
            "max_abs_diff": float((yd - yn).abs().max()),
            "abs_max": float(yn.abs().max()),
            "aux": [float(aux_disp), float(aux_dense)],
            "tolerance_row_rel": MOE_ROW_REL}
        log(f"[path 10] {cfg.name} layer-0 MoE, {t} tokens: dispatch (no "
            f"drop) vs dense row rel max {float(row.max()):.3e} (mean "
            f"{float(row.mean()):.3e}), max |diff| "
            f"{out['dispatch_vs_dense']['max_abs_diff']:.3e}; expert ids "
            f"equal")
        check(float(row.max()) <= MOE_ROW_REL and bool(
            torch.isfinite(yd).all()), f"{cfg.name}: dispatch vs dense row "
            f"rel {float(row.max())} > {MOE_ROW_REL}")
        check(float(aux_disp) == float(aux_dense), "aux differs")
        del y_disp, y_dense, yd, yn
        # the configured capacity: the dropped assignments
        cap = moe.capacity(t, cfg.moe)
        valid = moe._dispatch_tables(x2d, cfg.moe, topv, topi, cap)[2]
        counts = np.bincount(topi.cpu().numpy().ravel(), minlength=e)
        host = int(np.maximum(counts - cap, 0).sum())
        dev_dropped = int((~valid).sum())
        out["capacity"] = {"capacity_factor": cfg.moe.capacity_factor,
                           "slots": cap, "dropped": dev_dropped,
                           "dropped_host": host,
                           "dropped_share": dev_dropped / (t * kk),
                           "max_expert_load": int(counts.max())}
        log(f"[path 10] {cfg.name} capacity_factor "
            f"{cfg.moe.capacity_factor}: {cap} slots an expert, the fullest "
            f"{int(counts.max())}; dropped {dev_dropped} of {t * kk} "
            f"assignments ({dev_dropped / (t * kk):.4f}), host count {host}")
        check(dev_dropped == host, f"{cfg.name}: dispatch dropped "
              f"{dev_dropped} assignments, the host counts {host}")
        # times at this T (the prefill's layer shape)
        x3 = x2d[None]
        xe = torch.zeros((e, cap, d), dtype=x2d.dtype, device=x2d.device)
        wg, wu, wd = lp["w_gate"], lp["w_up"], lp["w_down"]
        timing = {
            "block_ms": events_ms(torch, lambda: moe.moe_block(x3, lp,
                                                               cfg.moe), 5),
            "route_ms": events_ms(torch, lambda: moe._route(
                x2d, lp["router"], cfg.moe), 5),
            "tables_ms": events_ms(torch, lambda: moe._dispatch_tables(
                x2d, cfg.moe, topv, topi, cap), 5),
            "experts_ms": events_ms(torch, lambda: torch.bmm(
                F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd), 5),
            "dense_decode_ms": events_ms(torch, lambda: moe.moe_block(
                x3[:, :LM_BATCH], lp, dense), 10)}
        flops = 2 * 3 * e * cap * d * f
        timing["experts_tflops"] = flops / (timing["experts_ms"] / 1e3) / 1e12
        timing["experts_bound_ms"] = max(
            flops / BF16_OPS_PER_S,
            (3 * e * d * f + 2 * e * cap * d) * 2 / HBM_BYTES_PER_S) * 1e3
        wbytes = 3 * e * d * f * 2 + d * e * 4
        timing["dense_decode_bound_ms"] = wbytes / HBM_BYTES_PER_S * 1e3
        timing["dispatch_rest_ms"] = (timing["block_ms"] - timing["route_ms"]
                                      - timing["tables_ms"]
                                      - timing["experts_ms"])
        out["timing"] = timing
        log(f"[path 10] {cfg.name} MoE block at T {t}: "
            f"{timing['block_ms']:.3f} ms (router {timing['route_ms']:.3f}, "
            f"tables {timing['tables_ms']:.3f}, expert matmuls "
            f"{timing['experts_ms']:.3f} = {timing['experts_tflops']:.1f} "
            f"TFLOP/s, bound {timing['experts_bound_ms']:.3f}; the rest "
            f"{timing['dispatch_rest_ms']:.3f}); dense at T {LM_BATCH} "
            f"{timing['dense_decode_ms']:.3f} ms (weights' bytes bound "
            f"{timing['dense_decode_bound_ms']:.3f})")
        del xe
    return out


def moe_config_path(torch, mods, base_cfg, counters):
    """Path 10 for one MoE LM: ``base_cfg`` at full width and depth, bf16,
    random weights from seed 0, attn_impl="flash"; the prefill on its
    configured MoE impl, the decode on ``shape_config``'s dense one.
    Checks (a)-(e) (see the module docstring). Returns (result dict, K5
    launches on the main run, K5's max |err| on the path's own q, k, v)."""
    tf, fa, moe, lm_param_count, shape_config, rms_norm, chunked = mods
    dev = torch.device("cuda")
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    dec_cfg = shape_config(cfg, "decode")
    check(cfg.moe.impl == "ep" and dec_cfg.moe.impl == "dense",
          f"{cfg.name}: prefill impl {cfg.moe.impl}, decode "
          f"{dec_cfg.moe.impl}")
    out = {"config": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ,
           "max_len": LM_MAX_LEN, "decode_steps": LM_DECODE,
           "prefill_moe_impl": cfg.moe.impl,
           "decode_moe_impl": dec_cfg.moe.impl,
           "params": lm_param_count(cfg),
           "active_params": lm_param_count(cfg, active_only=True)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = tf.lm_init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params_gb"] = torch.cuda.memory_allocated() / 1e9 - \
        out["mem_before_gb"]
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (LM_BATCH, LM_SEQ))).to(dev)

    # the main run: counts zeroed just before, read just after
    for fn in counters:
        fn.launches = 0
    fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    logits, toks, n_pre, n_dec, pre_ms, step_ms = lm_serve(
        torch, tf, fa, params, cfg, tokens, LM_DECODE, decode_cfg=dec_cfg)
    launches = fa.flash_attention_fwd.launches
    routes = dict(fa.flash_attention_fwd.launches_by_route)
    others = {fn.__name__: fn.launches for fn in counters
              if fn is not fa.flash_attention_fwd}
    out["k5_launches_by_route"] = routes
    log(f"[path 10] {cfg.name} prefill {LM_BATCH} x {LM_SEQ} ({cfg.moe.impl})"
        f" + {LM_DECODE} decode steps (dense): K5 launches {n_pre} in the "
        f"prefill, {n_dec} in the decode, by route {routes}; other kernels "
        f"{others}")
    # (a), (e)
    check(n_pre == cfg.n_layers and n_dec == 0 and launches == n_pre,
          f"K5 launched {n_pre} times in the prefill (want {cfg.n_layers}) "
          f"and {n_dec} in the decode (want 0)")
    check(routes["mma_bf16"] == launches, f"K5's launches did not all take "
          f"the tensor-core route: {routes}")
    check(not any(others.values()), "a search or CE kernel ran on path 10")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "bad prefill logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "bad tokens")
    out["k5_launches_prefill"] = n_pre
    out["k5_launches_decode"] = n_dec
    out["first_prefill_ms"] = pre_ms
    out["decode_step_ms"] = {"p50": float(np.median(step_ms)),
                             "p90": float(np.percentile(step_ms, 90)),
                             "first": step_ms[0]}
    out["decode_tok_per_s"] = LM_BATCH / (out["decode_step_ms"]["p50"] / 1e3)

    # (c) repeatability: a second prefill into a fresh cache
    cache = tf.init_cache(cfg, LM_BATCH, LM_MAX_LEN)
    again, _ = tf.lm_prefill(params, cfg, tokens, cache)
    del cache
    out["prefill_bit_equal"] = bool(torch.equal(again, logits))
    check(out["prefill_bit_equal"], f"{cfg.name}: two prefills differ (max "
          f"|diff| {float((again.float() - logits.float()).abs().max())})")
    del again

    # (d) the chunked route (teacher-forced decode on the flash tokens)
    cfg_c = dataclasses.replace(cfg, attn_impl="chunked")
    logits_c, toks_c, n_pre_c, _, _, _ = lm_serve(
        torch, tf, fa, params, cfg_c, tokens, LM_DECODE, teacher=toks,
        decode_cfg=shape_config(cfg_c, "decode"))
    check(n_pre_c == 0, "K5 ran on the chunked route")
    ldiff = float((logits[:, :cfg.vocab].float()
                   - logits_c[:, :cfg.vocab].float()).abs().max())
    agree = float((toks_c == toks).float().mean())
    x_f, (q, k, v) = moe_layer0(torch, tf, fa, rms_norm, chunked, cfg,
                                params, tokens, flash=True)
    x_c, _ = moe_layer0(torch, tf, fa, rms_norm, chunked, cfg, params,
                        tokens, flash=False)
    router = params["runs"][0]["moe"]["router"][0]
    with torch.inference_mode():
        sets_f = moe._route(x_f, router, cfg.moe)[1].sort(dim=-1).values
        sets_c = moe._route(x_c, router, cfg.moe)[1].sort(dim=-1).values
    set_diff = int((sets_f != sets_c).any(dim=-1).sum())
    del x_c, sets_f, sets_c, logits_c
    out["flash_vs_chunked"] = {
        "logits_max_abs_diff": ldiff,
        "logits_abs_max": float(logits[:, :cfg.vocab].float().abs().max()),
        "greedy_agreement": agree,
        "layer0_expert_sets_differ": set_diff,
        "layer0_tokens": LM_BATCH * LM_SEQ,
        "tolerance": {"agreement_floor": LM_AGREE_FLOOR}}
    log(f"[path 10] {cfg.name} flash vs chunked: logits max |diff| "
        f"{ldiff:.4f} (|logits| up to "
        f"{out['flash_vs_chunked']['logits_abs_max']:.3f}), greedy tokens "
        f"agree on {agree:.4f} of {toks.numel()}, layer-0 expert sets differ "
        f"on {set_diff} of {LM_BATCH * LM_SEQ} tokens")
    check(agree >= LM_AGREE_FLOOR, f"{cfg.name}: greedy agreement {agree} < "
          f"{LM_AGREE_FLOOR}")

    # lm_embed (K5 in every layer)
    n0 = fa.flash_attention_fwd.launches
    emb = tf.lm_embed(params, cfg, tokens)
    torch.cuda.synchronize()
    check(tuple(emb.shape) == (LM_BATCH, cfg.d_model)
          and bool(torch.isfinite(emb).all())
          and fa.flash_attention_fwd.launches - n0 == cfg.n_layers,
          f"lm_embed: {tuple(emb.shape)}, "
          f"{fa.flash_attention_fwd.launches - n0} K5 launches")
    out["embed_k5_launches"] = cfg.n_layers
    del emb

    # (a) K5 on the path's own layer-0 q, k, v; (b) the MoE block
    out["k5_main_checks"] = {}
    err = compare_k5(torch, fa, f"K5 {cfg.name} bf16", q, k, v, None,
                     out["k5_main_checks"])
    lp0 = {key: t[0] for key, t in params["runs"][0]["moe"].items()}
    out["moe_block"] = moe_block_checks(torch, moe, cfg, lp0, x_f)
    del x_f
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # timings, second call on
    k5 = k5_timing(torch, fa, q, k, v)
    del q, k, v

    def prefill_once():
        cache = tf.init_cache(cfg, LM_BATCH, LM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.lm_prefill(params, cfg, tokens, cache)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    pre = [prefill_once() for _ in range(3)]
    p50 = float(np.median(pre))
    model_flops = (2 * out["active_params"] * LM_BATCH * LM_SEQ
                   + cfg.n_layers * k5["ops"])
    out["prefill_ms"] = pre
    out["prefill_tok_per_s"] = LM_BATCH * LM_SEQ / (p50 / 1e3)
    out["prefill_model_flops"] = model_flops
    out["prefill_peak_share"] = model_flops / (p50 / 1e3) / BF16_OPS_PER_S
    out["moe_share_of_prefill"] = (cfg.n_layers
                                   * out["moe_block"]["timing"]["block_ms"]
                                   / p50)
    out["k5_share_of_prefill"] = cfg.n_layers * k5["ms"] / p50
    log(f"[timings] {cfg.name} prefill {LM_BATCH} x {LM_SEQ}: "
        f"{[round(t, 2) for t in pre]} ms, {out['prefill_tok_per_s']:.0f} "
        f"tok/s, {model_flops:.4g} FLOPs (active params + attention) = "
        f"{out['prefill_peak_share']:.4f} of the bf16 peak; MoE blocks "
        f"{out['moe_share_of_prefill']:.3f} of it, K5 "
        f"{out['k5_share_of_prefill']:.3f}; decode p50 "
        f"{out['decode_step_ms']['p50']:.3f} ms a step "
        f"({out['decode_tok_per_s']:.1f} tok/s); init {out['init_s']:.2f} s "
        f"({out['params_gb']:.2f} GB); peak memory "
        f"{out['peak_mem_gb']:.2f} GB")

    # the card's busy share: one prefill, then 10 decode steps
    cache = tf.init_cache(cfg, LM_BATCH, LM_MAX_LEN)
    step = iter(range(LM_SEQ, LM_MAX_LEN))
    nxt = toks[:, 0]
    out["busy"] = {
        "prefill": busy_share(
            torch, lambda: tf.lm_prefill(params, cfg, tokens, cache), 1,
            f"path 10 {cfg.name} prefill", by=MOE_KERNEL_GROUPS),
        "decode": busy_share(
            torch, lambda: tf.lm_decode_step(params, dec_cfg, nxt,
                                             next(step), cache), 10,
            f"path 10 {cfg.name} decode", by=MOE_KERNEL_GROUPS)}
    del params, cache
    torch.cuda.empty_cache()
    return out, launches, err, k5


def moe_path(torch, mods, configs, counters):
    """Path 10: ``moe_config_path`` for each MoE LM in turn (the first's
    tensors freed before the next). Returns (result dict, K5 launches on
    the main runs, K5's max |err|)."""
    out, launches, err = {"configs": []}, 0, 0.0
    for base_cfg in configs:
        res, n, e, k5 = moe_config_path(torch, mods, base_cfg, counters)
        res["k5_timing"] = k5
        out[base_cfg.name] = res
        out["configs"].append(base_cfg.name)
        launches += n
        err = max(err, e)
    check(launches > 0, "K5 never launched on path 10")
    return out, launches, err


def serve_rate(torch, fn, items, reps=RECSYS_REPS, warmup=1):
    """p50 ms of ``fn`` by CUDA events and the items it scores a second."""
    ms = events_ms(torch, fn, reps, warmup=warmup)
    return {"p50_ms": ms, "items_per_s": items / (ms / 1e3)}


def recsys_path(torch, mods, counters):
    """Path 11: the recsys family at the published configs (see the module
    docstring), without autograd. Returns (result dict, K4 launches in the
    two-tower fit)."""
    with torch.no_grad():
        return _recsys_path(torch, mods, counters)


def _recsys_path(torch, mods, counters):
    (rs, family, cfgs, recsys_ranking_batch, MPADConfig, fit_mpad, pw,
     cpu_generator) = mods
    sas_cfg, dien_cfg, ai_cfg, tt_mod = cfgs
    dev = torch.device("cuda")
    b = family.RECSYS_SHAPES["serve_p99"]["batch"]
    c = family.RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    k = family._TOPK
    rng = np.random.default_rng(SEED + 11)
    out = {"batch": b, "candidates": c, "k": k}

    # SASRec: the blocked running top-k over the 2^20-item catalog
    p = rs.sasrec_init(sas_cfg, seed=SEED)
    seq = rng.integers(0, sas_cfg.n_items, (b, sas_cfg.seq_len))
    seq[: b // 4, :10] = -1                  # a quarter left-padded
    seq = torch.from_numpy(seq).to(dev)
    s, ids = rs.sasrec_serve_topk(p, sas_cfg, seq, k=k)
    full = rs.sasrec_forward(p, sas_cfg, seq)[:, -1] @ p["item_emb"].T
    vals, oids = torch.topk(full, k, dim=1)
    kth = vals[:, -1:]

    def above(i):
        sc = full.gather(1, i)
        return torch.sort(torch.where(sc > kth, i, -1), dim=1).values

    same = bool(torch.equal(above(ids), above(oids)))
    sdiff = float((s - full.gather(1, ids)).abs().max())
    out["sasrec"] = {
        "serve_topk": serve_rate(torch, lambda: rs.sasrec_serve_topk(
            p, sas_cfg, seq, k=k), b * sas_cfg.n_items),
        "ids_equal_one_shot_above_kth": same,
        "positions_differing_from_one_shot": int((ids != oids).sum()),
        "score_max_abs_diff": sdiff}
    log(f"[path 11] sasrec serve_p99: batch {b} over {sas_cfg.n_items} "
        f"items, k {k}: {out['sasrec']['serve_topk']['p50_ms']:.3f} ms "
        f"({out['sasrec']['serve_topk']['items_per_s']:.4g} items/s); ids "
        f"above the k-th score equal a one-shot topk: {same} "
        f"({out['sasrec']['positions_differing_from_one_shot']} positions "
        f"differ in order), scores max |diff| {sdiff:.3e}")
    check(same and sdiff <= 1e-5 * float(vals.abs().max()),
          "sasrec_serve_topk differs from a one-shot topk")
    del p, full, vals, oids, kth, s, ids

    # DIEN: the ranking forward at batch b, then one history against c
    # candidates (GRU-1 once, the AUGRU over the candidates as a batch)
    p = rs.dien_init(dien_cfg, seed=SEED)
    batch = recsys_ranking_batch(SEED + 12, b, dien_cfg.seq_len,
                                 dien_cfg.n_items, dien_cfg.n_cats)
    logit, _ = rs.dien_forward(p, dien_cfg, batch)
    check(tuple(logit.shape) == (b,) and bool(torch.isfinite(logit).all()),
          "bad dien_forward logits")
    cand_items = torch.from_numpy(rng.integers(0, dien_cfg.n_items, c)).to(
        dev)
    cand_cats = torch.from_numpy(rng.integers(0, dien_cfg.n_cats, c)).to(dev)
    sb = {"hist_items": batch["hist_items"][:1],
          "hist_cats": batch["hist_cats"][:1], "cand_items": cand_items,
          "cand_cats": cand_cats}
    scores = rs.dien_score(p, dien_cfg, sb, chunk=RECSYS_DIEN_CHUNK)
    idx = torch.from_numpy(rng.choice(c, RECSYS_SAMPLE, replace=False)).to(
        dev)
    one, _ = rs.dien_forward(p, dien_cfg, {
        "hist_items": sb["hist_items"].expand(RECSYS_SAMPLE, -1),
        "hist_cats": sb["hist_cats"].expand(RECSYS_SAMPLE, -1),
        "target_item": cand_items[idx], "target_cat": cand_cats[idx]})
    ddiff = float((scores[idx] - one).abs().max())
    dok = bool(torch.allclose(scores[idx], one, rtol=RECSYS_RTOL,
                              atol=RECSYS_ATOL))
    out["dien"] = {
        "forward": serve_rate(torch, lambda: rs.dien_forward(p, dien_cfg,
                                                             batch), b),
        "score": serve_rate(torch, lambda: rs.dien_score(
            p, dien_cfg, sb, chunk=RECSYS_DIEN_CHUNK), c, reps=2, warmup=0),
        "score_chunk": RECSYS_DIEN_CHUNK,
        "score_vs_forward_max_abs_diff": ddiff, "sample": RECSYS_SAMPLE}
    log(f"[path 11] dien forward batch {b}: "
        f"{out['dien']['forward']['p50_ms']:.3f} ms; dien_score over {c} "
        f"candidates: {out['dien']['score']['p50_ms']:.1f} ms "
        f"({out['dien']['score']['items_per_s']:.4g} items/s); against the "
        f"forward on {RECSYS_SAMPLE}: max |diff| {ddiff:.3e}")
    check(dok and bool(torch.isfinite(scores).all()), f"dien_score differs "
          f"from dien_forward by {ddiff} (rtol {RECSYS_RTOL}, atol "
          f"{RECSYS_ATOL})")
    del p, batch, scores, sb, cand_items, cand_cats, one, logit

    # AutoInt: the forward at batch b, then c candidates in field 0
    p = rs.autoint_init(ai_cfg, seed=SEED)
    v, nf = ai_cfg.vocab_per_field, ai_cfg.n_fields
    fields = torch.from_numpy(rng.integers(0, v, (b, nf))).to(dev)
    logit = rs.autoint_forward(p, ai_cfg, fields)
    check(tuple(logit.shape) == (b,) and bool(torch.isfinite(logit).all()),
          "bad autoint_forward logits")
    user = torch.from_numpy(rng.integers(0, v, nf - 1)).to(dev)
    cand = torch.from_numpy(rng.integers(0, v, c)).to(dev)
    sc = rs.autoint_score_candidates(p, ai_cfg, user, cand)
    idx = torch.from_numpy(rng.choice(c, RECSYS_SAMPLE, replace=False)).to(
        dev)
    rows = torch.cat([cand[idx, None],
                      user[None].expand(RECSYS_SAMPLE, nf - 1)], dim=1)
    direct = rs.autoint_forward(p, ai_cfg, rows)
    adiff = float((sc[idx] - direct).abs().max())
    aok = bool(torch.allclose(sc[idx], direct, rtol=RECSYS_RTOL,
                              atol=RECSYS_ATOL))
    out["autoint"] = {
        "forward": serve_rate(torch, lambda: rs.autoint_forward(
            p, ai_cfg, fields), b),
        "score_candidates": serve_rate(
            torch, lambda: rs.autoint_score_candidates(p, ai_cfg, user,
                                                       cand), c),
        "candidates_vs_forward_max_abs_diff": adiff}
    log(f"[path 11] autoint forward batch {b}: "
        f"{out['autoint']['forward']['p50_ms']:.3f} ms; "
        f"score_candidates over {c}: "
        f"{out['autoint']['score_candidates']['p50_ms']:.2f} ms "
        f"({out['autoint']['score_candidates']['items_per_s']:.4g} "
        f"items/s); against the unchunked forward on {RECSYS_SAMPLE}: max "
        f"|diff| {adiff:.3e}")
    check(aok and bool(torch.isfinite(sc).all()), f"autoint candidate "
          f"scores differ from the forward by {adiff}")
    del p, fields, logit, user, cand, sc, rows, direct

    # two-tower: the item tower over c items gives the candidate cache;
    # the MPAD reducer fitted on K4 (counts zeroed just before the fit,
    # read just after); the three retrieval modes
    tt_cfg = tt_mod.CONFIG
    p = rs.twotower_init(tt_cfg, seed=SEED)
    items = torch.arange(c, device=dev)

    def tower():
        return torch.cat([
            rs.twotower_item(p, tt_cfg, items[i:i + RECSYS_TOWER_CHUNK])
            for i in range(0, c, RECSYS_TOWER_CHUNK)])

    cand_emb = tower()
    tower_rate = serve_rate(torch, tower, c, reps=3)
    rows = torch.randperm(c, generator=cpu_generator(SEED + 13))[:FIT_SAMPLE]
    sample = cand_emb[rows.to(dev)]
    fit_cfg = MPADConfig(**dict(FIT, m=tt_mod.MPAD_DIM), backend="kernel")
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red = fit_mpad(sample, fit_cfg)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k4_launches = pw.pairwise_stats_at_quantile.launches \
        + pw.pairwise_stats.launches
    check(pw.pairwise_stats_at_quantile.launches
          == fit_cfg.m * fit_cfg.iters, f"the two-tower fit launched K4's "
          f"fused entry {pw.pairwise_stats_at_quantile.launches} times, "
          f"want {fit_cfg.m * fit_cfg.iters}")
    cand_red = (cand_emb - red.mean) @ red.matrix.T
    cq, scale = rs.quantize_candidates(cand_red)
    hq, hscale = rs.quantize_candidates(cand_red.cpu())
    q_equal = bool(torch.equal(cq.cpu(), hq)) and bool(torch.equal(
        scale.cpu().view(torch.int32), hscale.view(torch.int32)))
    check(q_equal, "the int8 codes or scales differ from the host's")
    uid = torch.from_numpy(rng.integers(0, tt_cfg.n_users, 1)).to(dev)
    hist = torch.from_numpy(rng.integers(0, tt_cfg.n_items,
                                         (1, tt_cfg.n_user_feats))).to(dev)
    base = {"user_ids": uid, "hist_ids": hist, "cand_emb": cand_emb}
    modes = {
        "full": (base, {}),
        "mpad": (dict(base, cand_red=cand_red),
                 dict(reducer=(red.matrix, red.mean), rerank=tt_mod.RERANK)),
        "int8": (dict(base, cand_red_q=cq, cand_scale=scale),
                 dict(reducer=(red.matrix, red.mean), rerank=tt_mod.RERANK,
                      quantized=True))}
    u = rs.twotower_user(p, tt_cfg, uid, hist)
    s64 = (u.double() @ cand_emb.double().T)[0]
    v64, i64 = torch.topk(s64, k)
    kth64 = v64[-1]
    want = set(i64[v64 > kth64].tolist())
    got, retr = {}, {}
    for mode, (bt, kw) in modes.items():
        sm, im = rs.twotower_retrieve(p, tt_cfg, bt, k=k, **kw)
        got[mode] = im
        exact = s64[im]
        bound = tt_cfg.embed_dim * 2.0 ** -24 * (
            u.abs().double() @ cand_emb[im].abs().double().T)[0]
        retr[mode] = dict(serve_rate(torch, lambda: rs.twotower_retrieve(
            p, tt_cfg, bt, k=k, **kw), c, reps=10), **{
            "score_max_abs_diff_f64": float((sm.double() - exact).abs().max()),
            "scores_exact": bool(((sm.double() - exact).abs()
                                  <= bound).all()),
            "overlap_at_k_with_full": None})
        check(retr[mode]["scores_exact"], f"two-tower {mode}: a returned "
              f"score is not its id's exact score (max |diff| "
              f"{retr[mode]['score_max_abs_diff_f64']:.3e})")
    full_ids = set(got["full"].tolist())
    full_above = set(i for i in got["full"].tolist()
                     if float(s64[i]) > float(kth64))
    check(full_above == want and len(full_ids) == k, "two-tower full: the "
          "ids above the k-th score differ from an f64 scan's")
    for mode in modes:
        retr[mode]["overlap_at_k_with_full"] = len(
            full_ids & set(got[mode].tolist())) / k
    users = torch.from_numpy(rng.integers(0, tt_cfg.n_users, b)).to(dev)
    hists = torch.from_numpy(rng.integers(0, tt_cfg.n_items,
                                          (b, tt_cfg.n_user_feats))).to(dev)
    pitems = torch.from_numpy(rng.integers(0, tt_cfg.n_items, b)).to(dev)

    def pairwise():
        return torch.sum(rs.twotower_user(p, tt_cfg, users, hists)
                         * rs.twotower_item(p, tt_cfg, pitems), dim=-1)

    pw_scores = pairwise()
    check(tuple(pw_scores.shape) == (b,) and bool(
        torch.isfinite(pw_scores).all()), "bad pairwise scores")
    out["two_tower"] = {
        "item_tower": tower_rate, "fit_s": fit_s, "fit": dataclasses.asdict(
            fit_cfg), "k4_launches": k4_launches,
        "int8_codes_bit_equal_host": q_equal,
        "cache_bytes": {"full_f32": cand_emb.numel() * 4,
                        "mpad_f32": cand_red.numel() * 4,
                        "int8": cq.numel()},
        "retrieve": retr, "rerank": tt_mod.RERANK,
        "pairwise_serve_p99": serve_rate(torch, pairwise, b)}
    log(f"[path 11] two-tower: item tower over {c} items "
        f"{tower_rate['p50_ms']:.1f} ms; fit m {fit_cfg.m} on "
        f"{FIT_SAMPLE} rows {fit_s:.2f} s ({k4_launches} K4 launches); int8 "
        f"codes bit-equal to the host's: {q_equal}")
    for mode in modes:
        r = retr[mode]
        log(f"[path 11] two-tower retrieve {mode:4s}: p50 "
            f"{r['p50_ms']:.3f} ms ({r['items_per_s']:.4g} candidates/s), "
            f"overlap@{k} with full {r['overlap_at_k_with_full']:.2f}, "
            f"scores max |diff| to f64 {r['score_max_abs_diff_f64']:.2e}")
    log(f"[path 11] two-tower pairwise serve_p99 batch {b}: "
        f"{out['two_tower']['pairwise_serve_p99']['p50_ms']:.3f} ms")
    del p, cand_emb, cand_red, cq, sample
    torch.cuda.empty_cache()
    return out, k4_launches


def compare_agg(torch, ga, name, src, dst, mask, n, f, seed):
    """The aggregate on both orders of one graph against its plain version
    on the host copies, bit for bit, and repeated bit for bit; each
    launch counted on its order. Returns max |err| (0 when it passes)."""
    dev = torch.device("cuda")
    agg = ga.csr_gather_sum
    x = np.random.default_rng(seed).standard_normal((n, f), dtype=np.float32)
    host = ga.build_csr(*(torch.from_numpy(a) for a in (src, dst, mask)), n)
    card = ga.build_csr(*(torch.from_numpy(a).to(dev)
                          for a in (src, dst, mask)), n)
    xd = torch.from_numpy(x).to(dev)
    for order in ("fwd", "bwd"):
        o = getattr(card, order)
        n0 = agg.launches_by_order[o.by]
        got = agg(xd, o)
        again = agg(xd, o)
        torch.cuda.synchronize()
        check(agg.launches_by_order[o.by] == n0 + 2, f"{name}: not "
              f"launched on the {o.by} order")
        want = ga.csr_gather_sum_plain(torch.from_numpy(x), getattr(host,
                                                                   order))
        check(torch.equal(got.cpu(), want) and torch.equal(got, again),
              f"{name} ({o.by} order, F {f}): differs from the plain "
              "version on the host or between two calls (max |err| "
              f"{float((got.cpu() - want).abs().max())})")
    log(f"  {name}: N {n} E {len(src)} F {f}: bit-equal to the host's "
        "plain version on both orders, repeated bit for bit")
    return 0.0


def edge_cases_agg(torch, ga):
    """The aggregate on ragged power-law degrees with empty rows (a
    quarter of the nodes neither send nor receive), masks 0, 1 and 0.37,
    F 1, 31, 64, 100 and 1433 (scalar and float4 loads, one to 45 feature
    chunks); one 20,000-edge destination row and one 20,000-edge source
    row among short ones; a graph with no edges (zeros); f64 raises."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 25)
    n, e = 3000, 40_000
    w = 1.0 / np.arange(1, 3 * n // 4 + 1) ** 0.5
    src = rng.choice(3 * n // 4, size=e, p=w / w.sum()).astype(np.int32)
    dst = rng.integers(0, 3 * n // 4, e).astype(np.int32)
    mask = rng.choice(np.array([0.0, 1.0, 0.37], np.float32), e)
    for f in (1, 31, 64, 100, 1433):
        compare_agg(torch, ga, "ragged", src, dst, mask, n, f, f)
    n, e = 5000, 60_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[:20_000] = 17
    src[20_000:40_000] = 4242
    mask = (rng.random(e) > 0.1).astype(np.float32)
    for f in (64, 100):
        compare_agg(torch, ga, "long rows", src, dst, mask, n, f, f + 1)
    empty = np.zeros(0, np.int32)
    compare_agg(torch, ga, "no edges", empty, empty,
                np.zeros(0, np.float32), 100, 64, 3)
    csr = ga.build_csr(*(torch.zeros(4, dtype=torch.int32, device=dev),) * 2,
                       None, 4)
    try:
        ga.csr_gather_sum(torch.zeros((4, 8), dtype=torch.float64,
                                      device=dev), csr.fwd)
    except TypeError:
        pass
    else:
        check(False, "the aggregate took f64 input")
    return 0.0


def gnn_graphs(graph, fam):
    """Path 12's inputs on the host (numpy, from GNN_SEED): the two full
    graphs (make_random_graph, padded with masked 0 -> 0 edges to a
    multiple of 512, a GNN_LABEL_SHARE training label mask), the
    minibatch_lg batch sampled from a Reddit-sized graph, and the
    molecule batch (symmetric 0/1 adjacency, no self-loops)."""
    out = {}
    for i, sname in enumerate(("full_graph_sm", "ogb_products")):
        s = fam.GNN_SHAPES[sname]
        n, e = s["n_nodes"], s["n_edges"]
        feats, src, dst, labels = graph.make_random_graph(
            GNN_SEED + i, n, e, s["d_feat"], s["n_classes"])
        pad = fam.padded_edges(e) - e
        rng = np.random.default_rng(GNN_SEED + 10 + i)
        out[sname] = {
            "feats": feats,
            "edge_src": np.concatenate([src, np.zeros(pad, np.int32)]),
            "edge_dst": np.concatenate([dst, np.zeros(pad, np.int32)]),
            "edge_mask": np.concatenate([np.ones(e, np.float32),
                                         np.zeros(pad, np.float32)]),
            "labels": labels,
            "label_mask": (rng.random(n) < GNN_LABEL_SHARE).astype(
                np.float32)}
    s = fam.GNN_SHAPES["minibatch_lg"]
    feats, src, dst, labels = graph.make_random_graph(
        GNN_SEED + 2, REDDIT_NODES, REDDIT_EDGES, s["d_feat"],
        s["n_classes"])
    out["minibatch_lg"] = graph.sample_neighborhood_batch(
        GNN_SEED + 3, feats, src, dst, labels, s["batch_nodes"], s["fanout"])
    s = fam.GNN_SHAPES["molecule"]
    g, n = s["n_graphs"], s["n_nodes"]
    rng = np.random.default_rng(GNN_SEED + 4)
    upper = np.triu(rng.random((g, n, n)) < GNN_MOL_EDGE_P, 1)
    out["molecule"] = {
        "feats": rng.standard_normal((g, n, s["d_feat"]), dtype=np.float32),
        "adj": (upper | upper.transpose(0, 2, 1)).astype(np.float32),
        "labels": rng.integers(0, s["n_classes"], g).astype(np.int32)}
    return out


def start_gnn_graphs(graph, fam):
    """``gnn_graphs`` in a thread, started beside the kernels' build and the
    edge cases, where nothing is timed but the build (the host's generator
    takes tens of seconds at ogb_products' 61.9 M edges). Returns
    ``join()``, which waits and returns (graphs, seconds the thread took,
    seconds waited), re-raising the thread's error."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["graphs"] = gnn_graphs(graph, fam)
        except BaseException as exc:         # re-raised by join
            box["error"] = exc
        box["s"] = time.perf_counter() - t0

    worker = threading.Thread(target=run, name="gnn-graphs", daemon=True)
    worker.start()

    def join():
        t0 = time.perf_counter()
        worker.join()
        if "error" in box:
            raise box["error"]
        return box["graphs"], box["s"], time.perf_counter() - t0

    return join


@contextlib.contextmanager
def recorded_aggregates(ops):
    """Within the block every gin_aggregate forward and backward appends
    (order, input, output) to the yielded list: ``ops._GinAggregate``
    swapped for a subclass that calls it and records."""
    records = []
    base = ops._GinAggregate

    class Recorded(base):
        @staticmethod
        def forward(ctx, h, csr):
            out = base.forward(ctx, h, csr)
            records.append(("dst", h.detach(), out))
            return out

        @staticmethod
        def backward(ctx, g):
            gh, none = base.backward(ctx, g)
            if gh is not None:
                records.append(("src", g.detach(), gh))
            return gh, none

    ops._GinAggregate = Recorded
    try:
        yield records
    finally:
        ops._GinAggregate = base


def leaf_err(torch, got, want):
    """max |got - want| / (|want| + max |want|): a gradient leaf's error
    against GNN_RTOL."""
    want = want.to(got.device).float()
    scale = float(want.abs().max())
    return float(((got.float() - want).abs()
                  / (want.abs() + max(scale, 1e-30))).max())


class _ReluDecisions:
    """Stands in for ``torch.nn.functional`` inside ``models.gnn``: its
    ``relu`` records each call's input (``record``) or applies given
    decisions (``masks``: x * mask, in call order); every other name is
    the real module's."""

    def __init__(self, functional, masks=None):
        self._f, self.masks, self.inputs = functional, masks, []

    def __getattr__(self, name):
        return getattr(self._f, name)

    def relu(self, x):
        if self.masks is None:
            self.inputs.append(x.detach())
            return self._f.relu(x)
        mask = self.masks[len(self.inputs)]
        self.inputs.append(x.detach())
        return x * mask.to(x.dtype)


@contextlib.contextmanager
def relu_decisions(gnn, masks=None):
    """Within the block ``gnn``'s ReLUs go through ``_ReluDecisions``."""
    real = gnn.F
    gnn.F = _ReluDecisions(real, masks)
    try:
        yield gnn.F
    finally:
        gnn.F = real


def gin_step0(torch, mods, lf, params, batch, host, record):
    """Step 0's loss and gradients on the card against the port's CPU
    route on the same inputs (host copies of the parameters, the numpy
    batch). A ReLU's gradient is 0 or 1 by the sign of its input, and the
    card's matmuls round other than the host's, so an input within
    rounding of 0 may take the other side (on full_graph_sm, on an H100,
    one input of 1,733,120, at 7.6e-8 of its call's largest, moved layers
    0-2's gradients by up to 7.2e-4 of their largest entry). So: the loss
    within GNN_RTOL of the CPU route's; every ReLU input whose sign differs
    between the two within GNN_FLIP_REL of its call's largest input; and
    every gradient leaf within GNN_RTOL of the CPU route run with the
    card's ReLU decisions (``leaf_err``). With ``record``, every
    aggregate of the card's step (5 forward, 4 backward on a full graph)
    is held bit for bit against the plain version on the host copy of its
    input. Returns the readings."""
    gnn, ga, fam, optim, tree_map = mods
    fresh = tree_map(lambda t: t.detach().clone(), params)
    with contextlib.ExitStack() as stack:
        card = stack.enter_context(relu_decisions(gnn))
        if record:
            records = stack.enter_context(recorded_aggregates(ga.ops))
        loss_d, grads_d = optim.value_and_grad(lf, fresh, batch)
        torch.cuda.synchronize()
    hb = {k: torch.from_numpy(v) for k, v in host.items()}

    def cpu_params():
        return tree_map(lambda t: t.detach().cpu().clone(), params)

    with relu_decisions(gnn) as own:
        loss_c, grads_c = optim.value_and_grad(lf, cpu_params(), hb)
    masks = [x.cpu() > 0 for x in card.inputs]
    flips, flip_rel = 0, 0.0
    for x_d, x_c in zip(card.inputs, own.inputs):
        differ = (x_d.cpu() > 0) != (x_c > 0)
        if bool(differ.any()):
            flips += int(differ.sum())
            flip_rel = max(flip_rel, float(
                x_c[differ].abs().max() / x_c.abs().max()))
    with relu_decisions(gnn, masks):
        _, grads_m = optim.value_and_grad(lf, cpu_params(), hb)
    dloss = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    want, plain = dict(_keyed(grads_m)), dict(_keyed(grads_c))
    errs = {k: leaf_err(torch, g, want[k]) for k, g in _keyed(grads_d)}
    out = {"loss": float(loss_d), "loss_cpu": float(loss_c),
           "loss_rel": dloss, "relu_units": sum(x.numel() for x in masks),
           "relu_flips": flips, "relu_flip_max_rel": flip_rel,
           "grad_max_err": max(errs.values()),
           "grad_max_err_own_decisions": max(
               leaf_err(torch, g, plain[k]) for k, g in _keyed(grads_d)),
           "tolerance": {"rtol": GNN_RTOL, "flip_rel": GNN_FLIP_REL}}
    log(f"[path 12] step 0 against the CPU route: loss {float(loss_d):.6g} "
        f"/ {float(loss_c):.6g} (rel {dloss:.2e}); ReLU inputs of another "
        f"sign {flips} of {out['relu_units']} (largest {flip_rel:.2e} of its "
        f"call's); gradients within {out['grad_max_err']:.2e} of the CPU "
        f"route with the card's ReLU decisions "
        f"({out['grad_max_err_own_decisions']:.2e} with its own)")
    check(np.isfinite(float(loss_d)), "GIN step 0: non-finite loss")
    check(flip_rel <= GNN_FLIP_REL, f"GIN step 0: a ReLU input "
          f"{flip_rel} of its call's largest took another sign on the card")
    check(dloss <= GNN_RTOL and out["grad_max_err"] <= GNN_RTOL,
          f"GIN step 0 against the CPU route: loss rel {dloss}, gradient "
          f"errors {errs}")
    if record:
        src, dst, mask = (torch.from_numpy(host[k]) for k in (
            "edge_src", "edge_dst", "edge_mask"))
        n = host["feats"].shape[0]
        by = {"dst": 0, "src": 0}
        for order, x, y in records:
            a, b = (src, dst) if order == "dst" else (dst, src)
            want = ga.gather_sum_ref(x.cpu(), a, b, mask, n)
            check(torch.equal(y.cpu(), want), f"GIN step 0: an aggregate "
                  f"({order} order) differs from the plain version on the "
                  "host")
            by[order] += 1
        out["aggregates_bit_equal_host"] = by
        check(by == {"dst": 5, "src": 4}, f"GIN step 0 recorded {by} "
              "aggregates, want 5 forward and 4 backward")
    return out


def gin_train(torch, mods, lf, cfg, batch, full, seed=SEED):
    """GNN_STEPS AdamW steps (gnn_family's AdamW) of ``lf`` from
    gin_init_params(cfg, seed) on ``batch``: (losses, step ms, aggregate
    launches by order a step, final params)."""
    dev = torch.device("cuda")
    gnn, ga, fam, optim, _ = mods
    agg = ga.csr_gather_sum
    params = gnn.gin_init_params(cfg, seed=seed, device=dev)
    opt = optim.init_opt_state(params)
    step = optim.make_train_step(lf, fam._ADAM)
    losses, step_ms, per_step = [], [], []
    torch.cuda.synchronize()
    for _ in range(GNN_STEPS):
        n0 = dict(agg.launches_by_order)
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append({k: agg.launches_by_order[k] - n0[k] for k in n0})
    want = ({"dst": cfg.n_layers, "src": cfg.n_layers - 1} if full
            else {"dst": 0, "src": 0})
    check(all(p == want for p in per_step), f"{cfg.name}: aggregate launches "
          f"a step {per_step}, want {want}")
    check(all(np.isfinite(x) for x in losses), f"{cfg.name}: non-finite "
          f"loss {losses}")
    return losses, step_ms, per_step, params


def ogb_row_check(torch, mods, cfg, params, batch, host, csr):
    """ogb_products against the host on GNN_ROW_SAMPLE destination rows:
    layer 0's and layer 1's aggregate bit-equal to torch's CPU index_add
    over those rows' edges in edge order (selected from the edge lists as
    given, not from the card's CSR), and layer 0's output within GNN_RTOL
    of the CPU route's on the same rows."""
    gnn, ga, _, _, _ = mods
    dev = batch["feats"].device
    n = host["feats"].shape[0]
    rows = np.sort(np.random.default_rng(GNN_SEED + 5).choice(
        n, GNN_ROW_SAMPLE, replace=False))
    sel = np.zeros(n, bool)
    sel[rows] = True
    edges = sel[host["edge_dst"]]
    e_src = host["edge_src"][edges]
    local = torch.from_numpy(np.searchsorted(rows, host["edge_dst"][edges]))
    e_w = torch.from_numpy(host["edge_mask"][edges])
    src_d = torch.from_numpy(e_src).to(dev).long()
    rows_d = torch.from_numpy(rows).to(dev)
    lp = params["layers"][0]
    with torch.no_grad():
        h0 = batch["feats"]
        a0 = ga.gin_aggregate(h0, csr)
        h1 = gnn._mlp(lp["mlp"], (1.0 + lp["eps"]) * h0 + a0)
        a1 = ga.gin_aggregate(h1, csr)
        host_agg = {}
        for name, h, a in (("layer0", h0, a0), ("layer1", h1, a1)):
            msg = h[src_d].cpu()                  # the gathered rows, exact
            want = ga.gather_sum_ref(msg, torch.arange(msg.shape[0]), local,
                                     e_w, GNN_ROW_SAMPLE)
            check(torch.equal(a[rows_d].cpu(), want), f"ogb_products {name}: "
                  f"the aggregate of {GNN_ROW_SAMPLE} rows differs from the "
                  "host's index_add")
            host_agg[name] = want
        cpu0 = {k: v.detach().cpu() for k, v in lp["mlp"].items()}
        eps0 = lp["eps"].detach().cpu()
        h1_host = gnn._mlp(cpu0, (1.0 + eps0) * torch.from_numpy(
            host["feats"][rows]) + host_agg["layer0"])
        err = leaf_err(torch, h1[rows_d], h1_host)
    check(err <= GNN_RTOL, f"ogb_products layer 0's output on {GNN_ROW_SAMPLE}"
          f" rows: error {err} against the CPU route")
    return {"rows": GNN_ROW_SAMPLE, "edges": int(edges.sum()),
            "aggregates_bit_equal_host": ["layer0", "layer1"],
            "layer0_output_err": err, "tolerance": GNN_RTOL}, h1


def agg_bounds(n, e, f):
    """The aggregate's least time at (N, E, F): (ms by the contract's
    bytes, each input read once: x, rowptr, col, w, rows and out, bytes;
    ms by the gathered rows, an x row and an index and mask for every
    edge, bytes)."""
    once = 2 * n * f * 4 + (n + 1) * 4 + e * 8 + n * 4
    gathered = e * (4 * f + 8)
    return (once / HBM_BYTES_PER_S * 1e3, once,
            gathered / HBM_BYTES_PER_S * 1e3, gathered)


def src_row_check(torch, ga, host, csr, g):
    """The aggregate in the source order (the backward's) at ogb_products
    against the host on GNN_ROW_SAMPLE source rows, node 0 (the power
    law's longest row) among them: bit-equal to torch's CPU index_add of
    ``g``'s destination rows over those rows' edges in edge order
    (selected from the edge lists as given, not from the card's CSR)."""
    n = host["feats"].shape[0]
    rng = np.random.default_rng(GNN_SEED + 6)
    rows = np.sort(np.concatenate([[0], 1 + rng.choice(
        n - 1, GNN_ROW_SAMPLE - 1, replace=False)]))
    sel = np.zeros(n, bool)
    sel[rows] = True
    edges = sel[host["edge_src"]]
    local = torch.from_numpy(np.searchsorted(rows, host["edge_src"][edges]))
    e_w = torch.from_numpy(host["edge_mask"][edges])
    dst_d = torch.from_numpy(host["edge_dst"][edges]).to(g.device).long()
    rows_d = torch.from_numpy(rows).to(g.device)
    with torch.no_grad():
        got = ga.csr_gather_sum(g, csr.bwd)[rows_d].cpu()
        msg = g[dst_d].cpu()                      # the gathered rows, exact
    want = ga.gather_sum_ref(msg, torch.arange(msg.shape[0]), local, e_w,
                             rows.size)
    check(torch.equal(got, want), f"ogb_products: the source-order "
          f"aggregate of {rows.size} rows differs from the host's index_add")
    row0 = int((host["edge_src"] == 0).sum())
    log(f"[path 12] ogb_products source order: {rows.size} rows, "
        f"{int(edges.sum())} edges (node 0's {row0}), bit-equal to the "
        "host's index_add")
    return {"rows": int(rows.size), "edges": int(edges.sum()),
            "row0_edges": row0, "bit_equal_host": True}


def agg_timing(torch, ga, batch, host, csr, h1):
    """The aggregate at ogb_products: forward at F 100 (layer 0) and 64
    (layers 1-4), backward at 64, each by CUDA events beside its bounds,
    the backward's source order checked on a row sample of the gradient
    it times (``src_row_check``); at F 64 the plain version, torch.sparse.mm of the destination-order
    CSR by h (the library yardstick) and index_add_ on the materialised
    messages (two yardsticks the port never calls on this path)."""
    dev = torch.device("cuda")
    agg = ga.csr_gather_sum
    feats, n = batch["feats"], batch["feats"].shape[0]
    e = csr.fwd.col.shape[0]
    g = torch.randn(h1.shape, generator=torch.Generator(dev).manual_seed(
        SEED), device=dev)
    out = {}
    for name, x, order in (("fwd_f100", feats, csr.fwd),
                           ("fwd_f64", h1, csr.fwd),
                           ("bwd_f64", g, csr.bwd)):
        ms = cuda_ms(torch, lambda: agg(x, order), reps=5)
        b_ms, b_bytes, g_ms, g_bytes = agg_bounds(n, e, x.shape[1])
        out[name] = {"ms": ms, "bound_ms": b_ms, "bound_bytes": b_bytes,
                     "gathered_bound_ms": g_ms, "gathered_bytes": g_bytes,
                     "gathered_rate_tb_s": g_bytes / (ms / 1e3) / 1e12}
    out["bwd_f64"]["row_check"] = src_row_check(torch, ga, host, csr, g)
    del g
    ref = agg(h1, csr.fwd)
    check(torch.equal(ref, agg(h1, csr.fwd)), "the aggregate did not repeat "
          "bit for bit")
    r = out["fwd_f64"]
    r["plain_ms"] = cuda_ms(torch, lambda: ga.csr_gather_sum_plain(
        h1, csr.fwd), reps=2, warmup=1)
    a = torch.sparse_csr_tensor(csr.fwd.rowptr, csr.fwd.col, csr.fwd.w,
                                size=(n, n))
    r["library_ms"] = cuda_ms(torch, lambda: torch.sparse.mm(a, h1), reps=5)
    r["library_max_abs_diff"] = float((torch.sparse.mm(a, h1) - ref).abs()
                                      .max())
    msgs = h1[csr.src] * csr.mask[:, None]
    buf = torch.zeros_like(h1)
    r["index_add_ms"] = cuda_ms(
        torch, lambda: buf.zero_().index_add_(0, csr.dst, msgs), reps=3)
    r["index_add_max_abs_diff"] = float((buf - ref).abs().max())
    del msgs, buf, a
    log(f"[timings] aggregate at ogb_products (N {n}, E {e}): " + "; ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, gathered rows "
            f"{v['gathered_bound_ms']:.3f}: {v['gathered_rate_tb_s']:.2f} "
            "TB/s)" for k, v in out.items())
        + f"; at F 64 plain {r['plain_ms']:.2f} ms, torch.sparse.mm "
        f"{r['library_ms']:.3f} ms (max |diff| "
        f"{r['library_max_abs_diff']:.2e}), index_add_ on the messages "
        f"{r['index_add_ms']:.3f} ms (max |diff| "
        f"{r['index_add_max_abs_diff']:.2e})")
    return out


def gnn_path(torch, mods, graphs, counters):
    """Path 12: gin-tu at the four GNN_SHAPES (see the module docstring).
    Returns (result dict, aggregate launches on the main runs, the
    aggregate's timing at ogb_products)."""
    dev = torch.device("cuda")
    gnn, ga, fam, optim, tree_map, base_cfg = mods
    mods = mods[:5]
    agg = ga.csr_gather_sum
    losses_fn = {"full": gnn.gin_full_loss, "sampled": gnn.gin_sampled_loss,
                 "mol": gnn.gin_mol_loss}
    out, launches, timing = {}, 0, None
    for sname in ("full_graph_sm", "ogb_products", "minibatch_lg",
                  "molecule"):
        s = fam.GNN_SHAPES[sname]
        cfg = fam.shape_config(sname, base_cfg)
        host = graphs.pop(sname)
        full = s["regime"] == "full"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        r = {"regime": s["regime"], "config": cfg.name}
        if full:
            t0 = time.perf_counter()
            batch["csr"] = ga.build_csr(batch["edge_src"], batch["edge_dst"],
                                        batch["edge_mask"], s["n_nodes"])
            torch.cuda.synchronize()
            r["build_csr_s"] = time.perf_counter() - t0
            r["edges_padded"] = int(batch["edge_src"].shape[0])

        def lf(p, b, loss=losses_fn[s["regime"]], cfg=cfg):
            return loss(p, cfg, b)

        params = gnn.gin_init_params(cfg, seed=SEED, device=dev)
        if sname == "ogb_products":
            r["row_check"], h1 = ogb_row_check(torch, mods, cfg, params,
                                               batch, host, batch["csr"])
            del h1
        else:
            r["step0"] = gin_step0(torch, mods, lf, params, batch, host,
                                   record=sname == "full_graph_sm")
        del params
        # the main run: counts zeroed just before, read just after
        for fn in counters:
            fn.launches = 0
        agg.launches_by_order = {"dst": 0, "src": 0}
        losses, step_ms, per_step, params = gin_train(torch, mods, lf, cfg,
                                                      batch, full)
        launches += agg.launches
        r["launches_by_order"] = dict(agg.launches_by_order)
        others = {fn.__name__: fn.launches for fn in counters
                  if fn is not agg}
        check(not any(others.values()), f"another kernel ran on path 12: "
              f"{others}")
        r["peak_mem_gb"] = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        p50 = float(np.median(step_ms[1:]))
        flops = fam.gin_flops(base_cfg, sname)
        items = {"full": s.get("n_nodes"), "mol": s.get("n_graphs"),
                 "sampled": s.get("batch_nodes")}[s["regime"]]
        r.update({"losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
                  "items_per_s": items / (p50 / 1e3), "model_flops": flops,
                  "tflop_per_s": flops / (p50 / 1e3) / 1e12,
                  "launches_per_step": per_step})
        what = {"full": "nodes", "mol": "graphs",
                "sampled": "seed nodes"}[s["regime"]]
        if s["regime"] == "sampled":
            b, (f1, f2) = s["batch_nodes"], s["fanout"]
            r["gathered_nodes_per_s"] = b * (1 + f1 + f1 * f2) / (p50 / 1e3)
        log(f"[path 12] {cfg.name}: step p50 {p50:.2f} ms (steps 1-"
            f"{GNN_STEPS - 1}; step 0 {step_ms[0]:.2f}), "
            f"{r['items_per_s']:.4g} {what}/s, {flops:.4g} model FLOPs = "
            f"{r['tflop_per_s']:.3f} TFLOP/s; losses "
            f"{[round(x, 5) for x in losses]}; aggregate launches a step "
            f"{per_step[0]}; peak memory {r['peak_mem_gb']:.2f} GB")
        if sname == "full_graph_sm":
            # the same 3 steps again from the same start: bit for bit
            losses2, _, _, params2 = gin_train(torch, mods, lf, cfg, batch,
                                               full)
            same = losses2 == losses and all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    _keyed(params), _keyed(params2)))
            check(same, f"full_graph_sm: a second run of {GNN_STEPS} steps "
                  f"differs (losses {losses} / {losses2})")
            r["repeat_bit_equal"] = True
            del params2
        if sname == "ogb_products":
            lp = params["layers"][0]
            with torch.no_grad():
                h1 = gnn._mlp(lp["mlp"], (1.0 + lp["eps"]) * batch["feats"]
                              + ga.gin_aggregate(batch["feats"],
                                                 batch["csr"]))
            del params
            torch.cuda.empty_cache()
            timing = agg_timing(torch, ga, batch, host, batch["csr"],
                                h1)
            r["aggregate_timing"] = timing
            del h1
        out[sname] = r
        del batch, host
        params = None
    torch.cuda.empty_cache()
    check(launches > 0, "the aggregate never launched on path 12")
    return out, launches, timing


def moe_train_path(torch, mods, base_cfg, counters, snap=None):
    """Path 13, first half: ``base_cfg`` (granite-moe-1b-a400m) through
    ``lm_train_run`` as path 4 trains TinyLlama (K6 over the tied head
    embed.T; the MoE on its configured impl: with no mesh, ep runs
    dispatch), then K5 and K6 timed at its shapes. ``snap``: as
    ``lm_train_run``'s (path 14 (a)). Returns (result dict, K5 launches,
    K6 launches, K6's max |err| on the path's own inputs)."""
    dev = torch.device("cuda")
    import torch.nn.functional as F
    tf, fa, fce, optim, data, lm_param_count = mods

    def kept(g):
        moe = g["runs"][0]["moe"]
        return {"embed": g["embed"], "runs[0].wq": g["runs"][0]["wq"],
                "runs[0].moe.w_down": moe["w_down"],
                "runs[0].moe.router": moe["router"]}

    out, (params, opt, _, batches), k5_launches, k6_launches = lm_train_run(
        torch, mods, base_cfg, kept, counters, "path 13", TRAIN_STEPS,
        snap=snap)
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    out.update({"moe_impl": cfg.moe.impl, "params": lm_param_count(cfg),
                "active_params": lm_param_count(cfg, active_only=True)})

    # K5 and K6 at the path's shapes
    rng = np.random.default_rng(SEED + 13)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, TRAIN_SEQ, n, cfg.d_head), dtype=np.float32)).to(
        dev).to(torch.bfloat16)
        for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    k5 = k5_timing(torch, fa, q, k, v)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves)
    k5["function_backward_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        o, leaves, torch.ones_like(o), retain_graph=True), reps=2, warmup=1)
    del q, k, v, leaves, o
    with torch.no_grad():
        h = tf._final_hidden(cfg, params, batches[0]["tokens"])[0]
        hc = h[:, :cfg.seq_chunk].reshape(-1, cfg.d_model)
        del h
        head = tf._head(cfg, params).detach()
        lab = batches[0]["labels"][:, :cfg.seq_chunk].reshape(-1)
        err = compare_k6(torch, fce, "K6 path 13 bf16 tied", hc, head, lab,
                         cfg.vocab)
        k6_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd(hc, head, lab,
                                                        cfg.vocab), reps=10)
        plain_ms = cuda_ms(torch, lambda: fce.fused_ce_fwd_plain(
            hc, head, lab, cfg.vocab), reps=3, warmup=1)
        yard_ms = cuda_ms(torch, lambda: F.cross_entropy(
            (hc @ head[:, :cfg.vocab]).float(), lab, reduction="none"),
            reps=10)
    t = hc.shape[0]
    bound, by, nops, nbytes = k6_bound(t, cfg.d_model, head.shape[1], 2, 2)
    k6 = {"ms": k6_ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": by, "ops": nops, "bytes": nbytes,
          "yardstick_cross_entropy_ms": yard_ms,
          "shape": [t, cfg.d_model, head.shape[1]], "tied": True}
    log(f"[timings] path 13: K5 {k5['ms']:.4f} ms (bound {k5['bound_ms']:.4f}"
        f", SDPA {k5['library_ms']:.4f}), its Function's backward "
        f"{k5['function_backward_ms']:.1f} ms a layer; K6 tied bf16 "
        f"{k6_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"({by}) at T={t} D={cfg.d_model} V={head.shape[1]}; yardstick "
        f"cross_entropy((h @ w).float()) {yard_ms:.4f} ms")
    out["k5_timing"], out["k6_timing"] = k5, k6
    del hc, head, params, opt, batches
    torch.cuda.empty_cache()
    return out, k5_launches, k6_launches, err


def recsys_train_batch(torch, data, cpu_generator, name, cfg, b):
    """Model ``name``'s train_batch fields (JAX's batch_struct: int32 ids,
    f32 labels) at batch ``b``, drawn on the host from SEED + 30 and moved
    to the card; a quarter of the SASRec rows left-padded with -1."""
    dev = torch.device("cuda")
    gen = cpu_generator(SEED + 30)

    def ids(high, *shape):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int32)

    if name == "sasrec":
        out = {k: ids(cfg.n_items, b, cfg.seq_len)
               for k in ("seq", "pos", "neg")}
        for k in out:
            out[k][: b // 4, :10] = -1
    elif name == "dien":
        return data.recsys_ranking_batch(gen, b, cfg.seq_len, cfg.n_items,
                                         cfg.n_cats, device=dev)
    elif name == "autoint":
        out = {"field_ids": ids(cfg.vocab_per_field, b, cfg.n_fields),
               "label": (torch.rand((b,), generator=gen) > 0.5).float()}
    else:
        return data.twotower_batch(gen, b, cfg.n_users, cfg.n_items,
                                   cfg.n_user_feats, cfg.n_negatives,
                                   device=dev)
    return {k: v.to(dev) for k, v in out.items()}


def recsys_train_path(torch, mods, counters):
    """Path 13, second half: SASRec, DIEN, AutoInt and the two-tower model
    trained at the published configs and train_batch, f32, from seed 0,
    RECSYS_TRAIN_STEPS steps of recsys_family's AdamW each; step 0 on a
    RECSYS_CHECK_ROWS slice of the batch on the card against the port's
    CPU route on the same slice and parameters. Returns the result dict."""
    dev = torch.device("cuda")
    rs, family, cfgs, data, optim, tree_map, cpu_generator = mods
    models = {
        "sasrec": (cfgs[0], rs.sasrec_init, rs.sasrec_loss),
        "dien": (cfgs[1], rs.dien_init, rs.dien_loss),
        "autoint": (cfgs[2], rs.autoint_init, rs.autoint_loss),
        "two-tower-retrieval": (cfgs[3], rs.twotower_init,
                                rs.twotower_loss)}
    b = family.RECSYS_SHAPES["train_batch"]["batch"]
    out = {"batch": b}
    for name, (cfg, init, loss) in models.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        params = init(cfg, seed=SEED)
        batch = recsys_train_batch(torch, data, cpu_generator, name, cfg, b)

        def lf(p, bb, loss=loss, cfg=cfg):
            return loss(p, cfg, bb)

        # step 0 on a slice: the card against the CPU route
        # the two-tower's sampled negatives are the whole batch's
        shared = (("neg_items", "neg_logq") if name == "two-tower-retrieval"
                  else ())
        sl = {k: (v if k in shared else v[:RECSYS_CHECK_ROWS])
              for k, v in batch.items()}
        ld, gd = optim.value_and_grad(
            lf, tree_map(lambda t: t.detach().clone(), params), sl)
        lc, gc = optim.value_and_grad(
            lf, tree_map(lambda t: t.detach().cpu(), params),
            {k: v.cpu() for k, v in sl.items()})
        loss_rel = abs(float(ld) - float(lc)) / abs(float(lc))
        rels = {}
        for (key, a), (_, c) in zip(_keyed(gd), _keyed(gc)):
            c = c.to(dev)
            den = float(torch.linalg.vector_norm(c))
            if den > 1e-7:
                rels[key] = float(torch.linalg.vector_norm(a - c)) / den
        del gd, gc
        check(loss_rel <= RECSYS_LOSS_RTOL and all(
            v <= RECSYS_GRAD_REL for v in rels.values()),
            f"{name} step 0 on {RECSYS_CHECK_ROWS} rows against the CPU "
            f"route: loss rel {loss_rel}, gradient rel L2 {rels}")
        # the main run
        for fn in counters:
            fn.launches = 0
        step = optim.make_train_step(lf, family._ADAM)
        opt = optim.init_opt_state(params)
        losses, step_ms = [], []
        torch.cuda.synchronize()
        for _ in range(RECSYS_TRAIN_STEPS):
            t0 = time.perf_counter()
            lo, params, opt = step(params, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lo))
        check(all(np.isfinite(x) for x in losses), f"{name}: non-finite "
              f"loss {losses}")
        check(not any(fn.launches for fn in counters), f"a kernel ran in "
              f"{name}'s training")
        p50 = float(np.median(step_ms[1:]))
        r = {"batch": b, "losses": losses, "step_ms": step_ms,
             "step_ms_p50": p50, "examples_per_s": b / (p50 / 1e3),
             "peak_mem_gb": (torch.cuda.max_memory_allocated() - mem0) / 1e9,
             "step0_slice": {"rows": RECSYS_CHECK_ROWS, "loss": float(ld),
                             "loss_cpu": float(lc), "loss_rel": loss_rel,
                             "grad_rel_l2_max": max(rels.values()),
                             "leaves_compared": len(rels)}}
        log(f"[path 13] {name} train batch {b}: step p50 {p50:.1f} ms (step "
            f"0 {step_ms[0]:.1f}), {r['examples_per_s']:.4g} examples/s, "
            f"peak {r['peak_mem_gb']:.2f} GB; losses "
            f"{[round(x, 5) for x in losses]}; step 0 on {RECSYS_CHECK_ROWS} "
            f"rows: loss rel {loss_rel:.2e}, gradient rel L2 max "
            f"{r['step0_slice']['grad_rel_l2_max']:.2e} over {len(rels)} "
            "leaves")
        out[name] = r
        del params, opt, batch, sl
    torch.cuda.empty_cache()
    return out


def shard_adam(optim):
    """The AdamW of paths 4, 13 and 14."""
    return optim.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)


def leaf_update_rel(torch, got, want, start):
    """||got - want|| / ||want - start|| of one parameter leaf after some
    steps from ``start``: the relative L2 of its update, in f32."""
    g, w, p0 = got.float(), want.float(), start.float()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.clamp_min(torch.linalg.vector_norm(w - p0), 1e-30))


def shard_train_a(torch, mods, base_cfg, snap, counters):
    """Path 14 (a): ``base_cfg`` at path 13's shapes on a (1, 1) mesh over
    NCCL in this process, SHARD_TRAIN_STEPS sharded steps (EP at mp 1,
    ZeRO at dp 1) from path 13's parameters and batches, counts zeroed
    just before; their losses and parameters against path 13's first
    steps (``snap``). Returns (result dict, K5 launches, K6 launches)."""
    tf, fa, fce, optim, data, sh, pstep, make_mesh = mods
    import torch.distributed as dist
    from repro_torch.launch.step_analysis import tensor_bytes
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, 1), ("data", "model"), backend="nccl")
    try:
        params = tf.lm_init_params(cfg, seed=SEED)
        batches = list(data.lm_token_batches(
            SEED, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab,
            n_steps=SHARD_TRAIN_STEPS))
        pspec = sh.lm_param_specs(cfg)
        ospec = sh.zero_opt_specs(params, pspec, mesh)
        params = sh.shard_tree(mesh, params, pspec)
        opt = optim.init_zero_opt_state(mesh, params, pspec, ospec)
        step = pstep.make_sharded_train_step(cfg, shard_adam(optim), mesh,
                                             pspec, ospec)
        # the rank's argument bytes, which path 15 (b)'s dry-run predicts:
        # the parameter and moment blocks, and a step's batch as int32 (the
        # dry-run's dtype, JAX's; the pipeline yields int64)
        arg_bytes = {"params": tensor_bytes(params), "opt": tensor_bytes(opt),
                     "batch_int32": sum(t.numel() * 4
                                        for t in batches[0].values())}
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES,
                                                                 0)
        fce.fused_ce_fwd.launches_by_route = dict.fromkeys(fce.ROUTES, 0)
        losses, step_ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        k5, k6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
        routes5 = dict(fa.flash_attention_fwd.launches_by_route)
        routes6 = dict(fce.fused_ce_fwd.launches_by_route)
        others = {fn.__name__: fn.launches for fn in counters
                  if fn not in (fa.flash_attention_fwd, fce.fused_ce_fwd)}
        peak_bytes = torch.cuda.max_memory_allocated()
        peak = peak_bytes / 1e9
    finally:
        dist.destroy_process_group()
    want5 = SHARD_TRAIN_STEPS * cfg.n_layers * (2 if cfg.remat else 1)
    want6 = SHARD_TRAIN_STEPS * (TRAIN_SEQ // cfg.seq_chunk)
    check(k5 == want5 and k6 == want6, f"path 14 (a): K5 / K6 launched "
          f"{k5} / {k6} times, want {want5} / {want6}")
    check(routes5["mma_bf16"] == k5 and routes6["bf16"] == k6,
          f"path 14 (a): K5 {routes5} / K6 {routes6} by route")
    check(not any(others.values()), f"another kernel ran on path 14 (a): "
          f"{others}")
    loss_equal = [bool(torch.equal(a, b)) for a, b in
                  zip(losses, snap["losses"])]
    start = dict(_keyed(tf.lm_init_params(cfg, seed=SEED)))
    leaves = {}
    for key, p in _keyed(params):
        want = snap["params"][key].to(p.device)
        leaves[key] = {
            "bit_equal": bool(torch.equal(p.detach(), want)),
            "max_abs_diff": float((p.detach().float() - want.float()).abs()
                                  .max()),
            "update_rel_l2": leaf_update_rel(torch, p.detach(), want,
                                             start[key])}
    del start, params, opt
    torch.cuda.empty_cache()
    out = {"mesh": [1, 1], "backend": "nccl", "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": SHARD_TRAIN_STEPS,
           "losses": [float(x) for x in losses],
           "losses_path13": [float(x) for x in snap["losses"]],
           "loss_bit_equal": loss_equal, "leaves": leaves,
           "bit_equal": all(loss_equal)
           and all(v["bit_equal"] for v in leaves.values()),
           "step_ms": step_ms, "peak_mem_gb": peak,
           "peak_mem_bytes": peak_bytes, "argument_bytes": arg_bytes,
           "k5_launches_by_route": routes5, "k6_launches_by_route": routes6}
    worst = max(v["update_rel_l2"] for v in leaves.values())
    log(f"[path 14] (a) {cfg.name} on a (1, 1) NCCL mesh, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: steps {[round(t, 1) for t in step_ms]}"
        f" ms, losses {out['losses']} (path 13: {out['losses_path13']}), "
        f"bit-equal: losses {loss_equal}, "
        f"{sum(v['bit_equal'] for v in leaves.values())} of {len(leaves)} "
        f"leaves; worst update rel L2 {worst:.3e}; peak {peak:.2f} GB; K5 "
        f"{k5} / K6 {k6} launches")
    check(loss_equal[0], "path 14 (a): step 0's loss is not path 13's")
    check(out["bit_equal"], "path 14 (a): the sharded steps are not path "
          "13's bit for bit")
    return out, k5, k6


def shard_b_config(base_cfg, cf):
    """Path 14 (b)'s cut of ``base_cfg``: SHARD_B_LAYERS layers, K5,
    capacity_factor ``cf``."""
    return dataclasses.replace(
        base_cfg, n_layers=SHARD_B_LAYERS, attn_impl="flash",
        moe=dataclasses.replace(base_cfg.moe, capacity_factor=cf))


def zero_split(pspec, mspec, ndim):
    """[(dim, axes)] of the dims a moment's ZeRO-1 spec splits beyond its
    parameter's spec (``zero_opt_specs`` splits one whole dim over the
    data axes)."""
    pe = list(pspec) + [None] * (ndim - len(pspec))
    me = list(mspec) + [None] * (ndim - len(mspec))
    return [(d, b) for d, (a, b) in enumerate(zip(pe, me)) if a != b]


def zero_check_step(torch, mesh, step, params, opt, batch, adam, pspec,
                    ospec):
    """Path 14 (b)'s ZeRO-1 check: one more sharded step, whose update
    (``sharded_adamw_update``: each rank updates its data block of its
    parameter block with its moments, then all-gathers it over "data")
    is held bit for bit against the one-process ``adamw_update`` on this
    rank's parameter blocks from the same parameters, moments (gathered
    over the dims ZeRO splits) and gradient blocks, clipped by the norm
    the step used. A block updated in the wrong place, a gather left
    out or a moment block taken from another rank shows here, apart
    from Adam's sign amplification of rounding. Updates ``params`` and
    ``opt`` in place; returns the readings."""
    from repro_torch import optim
    from repro_torch._tree import tree_map
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel import step as pstep
    seen = {}
    real_update, real_norm = (pstep.sharded_adamw_update,
                              adamw_mod.sharded_global_norm)

    def clone(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    def recording_update(mesh_, grads, opt_state, params_, *rest):
        seen.update(grads=clone(grads), params=clone(params_),
                    m=clone(opt_state["m"]), v=clone(opt_state["v"]),
                    step=opt_state["step"].clone())
        return real_update(mesh_, grads, opt_state, params_, *rest)

    def recording_norm(*a):
        seen["norm"] = real_norm(*a)
        return seen["norm"]

    pstep.sharded_adamw_update = recording_update
    adamw_mod.sharded_global_norm = recording_norm
    try:
        _, params, opt = step(params, opt, batch)
    finally:
        pstep.sharded_adamw_update = real_update
        adamw_mod.sharded_global_norm = real_norm
    torch.cuda.synchronize()

    def param_block(mom, ps, ms):
        for dim, axes in zero_split(ps, ms, mom.dim()):
            mom = ctx.all_gather(mesh, mom, dim, axes)
        return mom

    # AdamW's clip: min(clip_norm / max(norm, 1e-9), 1)
    scale = torch.clamp_max(
        adam.clip_norm / torch.clamp_min(seen["norm"], 1e-9), 1.0)
    grads = tree_map(lambda g: g.float() * scale, seen["grads"])
    moments = {"step": seen["step"],
               "m": tree_map(param_block, seen["m"], pspec, ospec["m"]),
               "v": tree_map(param_block, seen["v"], pspec, ospec["v"])}
    want_p, want_o = optim.adamw_update(
        grads, moments, seen["params"],
        dataclasses.replace(adam, clip_norm=None))
    del seen, grads

    def zero_block(mom, ps, ms):
        for dim, axes in zero_split(ps, ms, mom.dim()):
            per = mom.shape[dim] // mesh.axis_size(axes)
            mom = mom.narrow(dim, mesh.axis_index(axes) * per, per)
        return mom

    out = {"leaves": 0, "params_bit_equal": 0, "moments_bit_equal": 0,
           "params_max_abs_diff": 0.0, "moments_max_abs_diff": 0.0,
           "zero_split_leaves": 0,
           "step_equal": bool(torch.equal(opt["step"], want_o["step"]))}
    got_p, got_m, got_v = (_keyed(params), _keyed(opt["m"]),
                           _keyed(opt["v"]))
    for (key, got), (_, want), (_, gm), (_, wm), (_, gv), (_, wv), \
            (_, ps), (_, ms) in zip(
                got_p, _keyed(want_p), got_m, _keyed(want_o["m"]), got_v,
                _keyed(want_o["v"]), _keyed(pspec), _keyed(ospec["m"])):
        wm, wv = zero_block(wm, ps, ms), zero_block(wv, ps, ms)
        out["leaves"] += 1
        out["zero_split_leaves"] += bool(zero_split(ps, ms, got.dim()))
        out["params_bit_equal"] += bool(torch.equal(got.detach(), want))
        out["moments_bit_equal"] += bool(torch.equal(gm, wm)
                                         and torch.equal(gv, wv))
        out["params_max_abs_diff"] = max(
            out["params_max_abs_diff"],
            float((got.detach().float() - want.float()).abs().max()))
        out["moments_max_abs_diff"] = max(
            out["moments_max_abs_diff"], float((gm - wm).abs().max()),
            float((gv - wv).abs().max()))
    return out


def shard_train_rank(mesh, tmp):
    """One gloo rank of path 14 (b) on the card (the module docstring, phase
    35): step 0's gradient blocks (the mean over "data"), two sharded steps
    timed with the bytes this rank puts into each collective kind and its
    K5 / K6 launches, the parameters gathered after them, a third step's
    ZeRO-1 update against the one-process update (``zero_check_step``);
    then layer 0's
    EP block at capacity_factor 1.25 on the reference's layer-0 input,
    recording the expert ids and the dropped assignments. Returns every
    rank's readings, and rank 0's comparisons with the one-process
    reference in ``tmp``."""
    import torch
    import torch.distributed as dist
    from repro_torch import data, optim
    from repro_torch._tree import keyed_leaves
    from repro_torch.configs.granite_moe_1b import CONFIG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as fce
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import step as pstep
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = shard_b_config(CONFIG, CONFIG.moe.n_experts / CONFIG.moe.top_k)
    full = tf.lm_init_params(cfg, seed=SEED, device=dev)
    pspec = sh.lm_param_specs(cfg)
    ospec = sh.zero_opt_specs(full, pspec, mesh)
    params = sh.shard_tree(mesh, full, pspec)
    del full
    opt = optim.init_zero_opt_state(mesh, params, pspec, ospec)
    step = pstep.make_sharded_train_step(cfg, shard_adam(optim), mesh, pspec,
                                         ospec)
    bspec = pstep.lm_batch_specs(mesh)
    batches = [sh.shard_tree(mesh, b, bspec) for b in data.lm_token_batches(
        SEED, SHARD_B_BATCH, SHARD_B_SEQ, cfg.vocab,
        n_steps=SHARD_TRAIN_STEPS, device=dev)]
    ref = (torch.load(os.path.join(tmp, "reference.pt"), map_location=dev)
           if mesh.rank == 0 else None)
    mine = {"rank": mesh.rank, "coords": mesh.coords}

    # step 0's gradient, every leaf gathered to full
    loss0, g0 = pstep.sharded_value_and_grad(cfg, mesh, pspec, params,
                                             batches[0])
    g0 = sh.gather_tree(mesh, g0, pspec)
    mine["loss0"] = float(loss0)
    grad_rel = None
    if ref is not None:
        grad_rel = {key: float(
            torch.linalg.vector_norm(g.float() - ref["grads0"][key].float())
            / torch.linalg.vector_norm(ref["grads0"][key].float()))
            for key, g in keyed_leaves(g0)}
    del g0

    # the timed steps: launches, the bytes each collective kind takes (the
    # mesh wrappers' own counter, context.count_collectives, which the
    # dry-run's trace reads too)
    for fn in (fa.flash_attention_fwd, fce.fused_ce_fwd):
        fn.launches = 0
    fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    fce.fused_ce_fwd.launches_by_route = dict.fromkeys(fce.ROUTES, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step = [], [], []
    with ctx.count_collectives() as moved:
        for b in batches:
            n5, n6 = fa.flash_attention_fwd.launches, fce.fused_ce_fwd.launches
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            per_step.append((fa.flash_attention_fwd.launches - n5,
                             fce.fused_ce_fwd.launches - n6))
    mine.update({
        "step_ms": step_ms, "losses": losses, "launches_per_step": per_step,
        "k5_launches_by_route": dict(fa.flash_attention_fwd.launches_by_route),
        "k6_launches_by_route": dict(fce.fused_ce_fwd.launches_by_route),
        "collective_bytes_per_step": {
            kind.replace("-", "_"): moved.bytes[kind] / len(batches)
            for kind in ("all-gather", "all-reduce", "all-to-all")},
        "collective_calls_per_step": {
            kind.replace("-", "_"): moved.calls[kind] / len(batches)
            for kind in ("all-gather", "all-reduce", "all-to-all")},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # the parameters after the two timed steps (gather_tree's leaves hold
    # values of their own: the ZeRO check's third step does not move them)
    after = sh.gather_tree(mesh, params, pspec)
    start = dict(keyed_leaves(tf.lm_init_params(cfg, seed=SEED, device=dev)))
    update_rel = None
    if ref is not None:
        update_rel = {key: leaf_update_rel(torch, p.detach(),
                                           ref["params"][key], start[key])
                      for key, p in keyed_leaves(after)}
    del after, ref
    mine["zero_check"] = zero_check_step(torch, mesh, step, params, opt,
                                         batches[-1], shard_adam(optim),
                                         pspec, ospec)
    del params, opt

    # layer 0's EP block at capacity_factor 1.25
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=CONFIG.moe.
                               capacity_factor)
    x0 = torch.load(os.path.join(tmp, "layer0_input.pt"), map_location=dev)
    x0 = sh.rank_block(mesh, x0.reshape(SHARD_B_BATCH, SHARD_B_SEQ, -1),
                       sh.P("data"))
    lp = {n: sh.rank_block(mesh, start[f"['runs'][0]['moe']['{n}']"][0],
                           spec)
          for n, spec in (("router", sh.P(None, "model")),
                          ("w_gate", sh.P("model")), ("w_up", sh.P("model")),
                          ("w_down", sh.P("model")))}
    del start
    seen = {}
    route, tables = moe._route, moe._dispatch_tables

    def recording_route(x2d, router, c):
        res = route(x2d, router, c)
        seen["ids"] = res[1].cpu().numpy()
        return res

    def recording_tables(*a):
        res = tables(*a)
        seen["dropped"] = int((~res[2]).sum())
        return res

    moe._route, moe._dispatch_tables = recording_route, recording_tables
    try:
        with torch.no_grad(), ctx.mesh_context(mesh):
            y, aux = moe.moe_block(x0, lp, mcfg)
    finally:
        moe._route, moe._dispatch_tables = route, tables
    t_mp = SHARD_B_BATCH // mesh.shape["data"] * SHARD_B_SEQ \
        // mesh.shape["model"]
    m = mesh.coords["model"]
    mine["ep"] = {"y": y.reshape(-1, y.shape[-1])[m * t_mp:(m + 1) * t_mp]
                  .float().cpu().numpy(), "aux": float(aux),
                  "ids": seen["ids"], "dropped": seen["dropped"]}
    every = [None] * mesh.size
    dist.all_gather_object(every, mine)
    return {"ranks": every, "grad0_rel_l2": grad_rel,
            "update_rel_l2": update_rel}


def shard_train_b(torch, mods, base_cfg, run_ranks, smi):
    """Path 14 (b): the one-process reference (two make_train_step steps of
    ``shard_b_config`` at capacity_factor E / K on SHARD_B_BATCH x
    SHARD_B_SEQ, step 0's gradient, layer 0's MoE input), then
    SHARD_MESH gloo ranks on cuda:0 (``shard_train_rank``), then the
    one-process oracle of layer 0's EP block at the config's capacity
    factor: dispatch on each model slice at its own capacity. Returns
    (result dict, each rank's K5 and K6 launches)."""
    tf, fa, fce, optim, data, moe, rms_norm, chunked_attention = mods
    import tempfile
    e, k = base_cfg.moe.n_experts, base_cfg.moe.top_k
    cfg = shard_b_config(base_cfg, e / k)
    tmp = tempfile.mkdtemp(prefix="qpad-path14-")
    out = {"mesh": list(SHARD_MESH), "axes": ["data", "model"],
           "backend": "gloo", "device": "cuda:0", "layers": cfg.n_layers,
           "batch": SHARD_B_BATCH, "seq": SHARD_B_SEQ,
           "steps": SHARD_TRAIN_STEPS, "capacity_factor": e / k,
           "note": "gloo on one card (every collective staged through host "
                   "memory): not a deployment's number", "card": smi}
    try:
        torch.cuda.empty_cache()
        params = tf.lm_init_params(cfg, seed=SEED)
        batches = list(data.lm_token_batches(
            SEED, SHARD_B_BATCH, SHARD_B_SEQ, cfg.vocab,
            n_steps=SHARD_TRAIN_STEPS))
        x0 = moe_layer0(torch, tf, fa, rms_norm, chunked_attention, cfg,
                        params, batches[0]["tokens"], flash=True)[0]
        torch.save(x0.clone(), os.path.join(tmp, "layer0_input.pt"))

        def loss_fn(p, b):
            return tf.lm_train_forward(p, cfg, b)

        _, g0 = optim.value_and_grad(loss_fn, params, batches[0])
        grads0 = {key: g.detach() for key, g in _keyed(g0)}
        del g0
        step = optim.make_train_step(loss_fn, shard_adam(optim))
        opt = optim.init_opt_state(params)
        losses, step_ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        torch.save({"grads0": grads0, "params": {
            key: p.detach() for key, p in _keyed(params)}},
            os.path.join(tmp, "reference.pt"))
        out["one_process"] = {"losses": losses, "step_ms": step_ms}
        del params, opt, grads0, step
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        got = run_ranks(shard_train_rank, SHARD_MESH, (tmp,),
                        backend="gloo", device="cuda:0",
                        axis=("data", "model"), timeout=900)
        out["ranks_wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = got["ranks"]
    dloss = [abs(a - b) for a, b in zip(ranks[0]["losses"], losses)]
    out.update({
        "losses": ranks[0]["losses"], "abs_dloss": dloss,
        "grad0_rel_l2": got["grad0_rel_l2"],
        "update_rel_l2": got["update_rel_l2"],
        "tolerance": {"loss_atol": TRAIN_LOSS_ATOL,
                      "rel_l2": TRAIN_GRAD_REL},
        "ranks": [{key: r[key] for key in (
            "rank", "coords", "step_ms", "launches_per_step",
            "k5_launches_by_route", "k6_launches_by_route",
            "collective_bytes_per_step", "peak_mem_gb")} for r in ranks]})
    want = (2 * cfg.n_layers if cfg.remat else cfg.n_layers,
            SHARD_B_SEQ // cfg.seq_chunk)
    for r in ranks:
        check(all(tuple(p) == want for p in r["launches_per_step"]),
              f"path 14 (b) rank {r['rank']}: K5 / K6 launches a step "
              f"{r['launches_per_step']}, want {want}")
        check(r["k5_launches_by_route"]["mma_bf16"] == want[0] *
              SHARD_TRAIN_STEPS and r["k6_launches_by_route"]["bf16"] ==
              want[1] * SHARD_TRAIN_STEPS, f"path 14 (b) rank {r['rank']}: "
              "K5 / K6 off their bf16 routes")
        check(r["losses"] == ranks[0]["losses"], "path 14 (b): the ranks "
              "report different losses")
    check(all(np.isfinite(ranks[0]["losses"])), "path 14 (b): a loss is "
          "not finite")
    log(f"[path 14] (b) {cfg.name} cut to {cfg.n_layers} layers, "
        f"{SHARD_B_BATCH} x {SHARD_B_SEQ}, {SHARD_MESH} gloo ranks on one "
        f"card: losses {ranks[0]['losses']} vs one process {losses}; step "
        f"ms by rank {[[round(t, 1) for t in r['step_ms']] for r in ranks]}"
        f" (one process {[round(t, 1) for t in step_ms]}); peak GB by rank "
        f"{[round(r['peak_mem_gb'], 2) for r in ranks]}; bytes a step by "
        f"kind (rank 0) {ranks[0]['collective_bytes_per_step']}; step 0 "
        f"gradient rel L2 worst {max(got['grad0_rel_l2'].values()):.3e}, "
        f"update rel L2 worst {max(got['update_rel_l2'].values()):.3e} "
        f"({smi})")
    check(all(d <= TRAIN_LOSS_ATOL for d in dloss),
          f"path 14 (b): |dloss| {dloss} beyond {TRAIN_LOSS_ATOL}")
    check(all(v <= TRAIN_GRAD_REL for v in got["grad0_rel_l2"].values()),
          f"path 14 (b): step 0's gradient rel L2 {got['grad0_rel_l2']} "
          f"beyond {TRAIN_GRAD_REL}")
    zc = [r["zero_check"] for r in ranks]
    out["zero_check"] = zc
    log(f"[path 14] (b) ZeRO-1 check (a third step against the "
        f"one-process adamw_update on each rank's blocks): parameters "
        f"bit-equal {[z['params_bit_equal'] for z in zc]}, moments "
        f"{[z['moments_bit_equal'] for z in zc]} of {zc[0]['leaves']} leaves "
        f"({zc[0]['zero_split_leaves']} with ZeRO-split moments); max abs "
        f"diff {max(z['params_max_abs_diff'] for z in zc):.3e} / "
        f"{max(z['moments_max_abs_diff'] for z in zc):.3e}")
    check(all(z["step_equal"] and z["params_bit_equal"] == z["leaves"]
              and z["moments_bit_equal"] == z["leaves"] for z in zc),
          f"path 14 (b): the ZeRO-1 update is not the one-process update "
          f"on the ranks' blocks: {zc}")

    # layer 0's EP block at the config's capacity factor, against dispatch
    # on each model slice with its own capacity
    mcfg = dataclasses.replace(base_cfg.moe, impl="dispatch")
    p0 = tf.lm_init_params(cfg, seed=SEED)["runs"][0]["moe"]
    lp = {n: t[0] for n, t in p0.items()}
    del p0
    dp, mp = SHARD_MESH
    xs_all = x0.reshape(dp, -1, x0.shape[-1])
    t_mp = xs_all.shape[1] // mp
    ep = {"capacity_factor": mcfg.capacity_factor,
          "capacity": moe.capacity(t_mp, mcfg), "tokens_a_slice": t_mp,
          "row_rel_max": 0.0, "dropped": [], "dropped_host": []}
    slice_aux = []
    with torch.no_grad():
        for r in ranks:
            d, m = r["coords"]["data"], r["coords"]["model"]
            xs = xs_all[d, m * t_mp:(m + 1) * t_mp]
            y, aux = moe.moe_block(xs[None], lp, mcfg)
            _, ids, _ = moe._route(xs, lp["router"], mcfg)
            ids = ids.cpu().numpy()
            slice_aux.append(float(aux))
            check(np.array_equal(r["ep"]["ids"], ids), f"path 14 (b) rank "
                  f"{r['rank']}: EP's expert ids are not its slice's")
            counts = np.bincount(ids.ravel(), minlength=e)
            host = int(np.maximum(counts - ep["capacity"], 0).sum())
            ep["dropped"].append(r["ep"]["dropped"])
            ep["dropped_host"].append(host)
            want_y = y[0].float()
            got_y = torch.from_numpy(r["ep"]["y"]).to(want_y.device)
            rel = float((torch.linalg.vector_norm(got_y - want_y, dim=1)
                         / torch.linalg.vector_norm(want_y, dim=1)
                         .clamp_min(1e-30)).max())
            ep["row_rel_max"] = max(ep["row_rel_max"], rel)
    ep["aux"] = ranks[0]["ep"]["aux"]
    ep["aux_oracle"] = float(np.mean(slice_aux))
    ep["aux_rel"] = abs(ep["aux"] - ep["aux_oracle"]) / abs(ep["aux_oracle"])
    out["ep_block"] = ep
    log(f"[path 14] (b) layer 0's EP block at cf {mcfg.capacity_factor} "
        f"(capacity {ep['capacity']} for {t_mp} tokens a slice): ids equal "
        f"the oracle's on every rank, rows rel max {ep['row_rel_max']:.3e}, "
        f"dropped {ep['dropped']} (host {ep['dropped_host']}), aux "
        f"{ep['aux']:.6f} vs {ep['aux_oracle']:.6f}")
    check(ep["row_rel_max"] <= MOE_ROW_REL, f"path 14 (b): EP rows "
          f"{ep['row_rel_max']} beyond {MOE_ROW_REL}")
    check(ep["dropped"] == ep["dropped_host"], "path 14 (b): EP's dropped "
          "assignments are not the host's count")
    check(ep["aux_rel"] <= SHARD_AUX_RTOL, f"path 14 (b): aux "
          f"{ep['aux']} vs {ep['aux_oracle']}")
    del x0, xs_all
    torch.cuda.empty_cache()
    launches = [sum(r["k5_launches_by_route"].values()) for r in ranks], \
        [sum(r["k6_launches_by_route"].values()) for r in ranks]
    return out, launches


def dry_smoke_cases():
    """Path 15 (c)'s SMOKE cells: granite SMOKE's train step (K5 on the f32
    route, K6, the dispatch MoE) and a small full-graph GIN's (the
    aggregate); {name: (arch, cell, its config)}."""
    from repro_torch.configs import LM_CONFIGS, gnn_family, lm_family
    from repro_torch.models import gnn
    cfg = LM_CONFIGS["granite-moe-1b-a400m"][1]
    lm = lm_family.make_lm_arch(
        "granite-moe-1b-a400m", cfg, cfg, long_ok=False,
        shapes={"train_4k": dict(kind="train", batch=DRY_SMOKE_BATCH,
                                 seq=DRY_SMOKE_SEQ)})
    base = gnn.GINConfig(name="gin-smoke", n_layers=3, d_hidden=16)
    shapes = {"full_graph_sm": dict(regime="full", n_nodes=500,
                                    n_edges=2000, d_feat=8, n_classes=3)}
    gin = gnn_family.make_gin_arch("gin-tu", base, shapes=shapes)
    return {"lm": (lm, "train_4k", cfg),
            "gin": (gin, "full_graph_sm",
                    gnn_family.shape_config("full_graph_sm", base, shapes))}


def dryrun_smoke():
    """``--dryrun-smoke``: path 15 (c)'s fake traces (a (1, 1) fake world,
    fake CUDA tensors), one JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for name, (arch, cell, _) in dry_smoke_cases().items():
        out[name] = run_cell(arch.name, cell, (1, 1), None, 0, "cuda",
                             arch=arch, verbose=False)
    print(json.dumps({"dryrun_smoke": out}))
    return 0


def dry_real_args(torch, name, arch, cell, cfg):
    """Seeded arguments of a SMOKE cell on the card (int32 ids, as the
    dry-run's abstract arguments)."""
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tf
    from repro_torch.optim import init_opt_state
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    dev = torch.device("cuda")

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if name == "lm":
        params = tf.lm_init_params(cfg, SEED, dev)
        toks = ints(cfg.vocab, DRY_SMOKE_BATCH, DRY_SMOKE_SEQ)
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    else:
        params = gnn.gin_init_params(cfg, SEED, dev)
        fake = arch.abstract_args(cell, "meta")[-1]
        n, ep = fake["feats"].shape[0], fake["edge_src"].shape[0]
        mask = torch.zeros(ep, device=dev)
        mask[:2000] = 1.0
        batch = {"feats": torch.randn(fake["feats"].shape, generator=g,
                                      device=dev),
                 "edge_src": ints(n, ep), "edge_dst": ints(n, ep),
                 "edge_mask": mask, "labels": ints(cfg.n_classes, n),
                 "label_mask": torch.ones(n, device=dev)}
    return params, init_opt_state(params), batch


def dry_reading(rec):
    """The numbers path 15 compares, from a dry-run record."""
    coll = rec["collectives"]
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "argument_bytes": rec["memory"]["argument_size_in_bytes"],
            "coll": {k: coll[k] for k in coll if k not in ("total",
                                                           "counts")},
            "calls": coll["counts"], "launches": rec["launches"]}


def dry_jobs(out):
    """The path 15 subprocesses, the longest traces first: {name: argv}."""
    dr = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
          "cuda", "--out", out]
    granite = dr + ["--arch", "granite-moe-1b-a400m", "--shape", "train_4k"]
    jobs = {"cut_a": granite + ["--mesh-shape", "1x1", "--batch",
                                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]}
    for shape in DRY_FOUR_CARDS:
        jobs[f"olmoe_{shape}"] = dr + [
            "--arch", "olmoe-1b-7b", "--shape", "train_4k", "--mesh-shape",
            shape, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    for arch, cell, mesh in DRY_CELLS:
        jobs[f"{arch}.{cell}.{mesh}"] = dr + ["--arch", arch, "--shape", cell,
                                              "--mesh", mesh]
    cut_b = ["--mesh-shape", "x".join(map(str, SHARD_MESH)), "--batch",
             str(SHARD_B_BATCH), "--seq", str(SHARD_B_SEQ), "--layers",
             str(SHARD_B_LAYERS), "--capacity-factor", "4.0"]
    jobs["cut_b"] = granite + cut_b
    jobs["cut_b_meta"] = [a if a != "cuda" else "meta" for a in granite] \
        + cut_b
    jobs["cut_b_meta"][jobs["cut_b_meta"].index(out)] = out + "_meta"
    jobs["mpad_world1"] = [sys.executable, "-m",
                           "repro_torch.launch.dryrun_mpad", "--ranks", "1",
                           "--device", "cuda", "--out",
                           os.path.join(out, "mpad_world1.json")]
    jobs["smoke"] = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     "--dryrun-smoke"]
    jobs["serve"] = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     "--dryrun-serve"]
    return jobs


def start_dry_jobs(out):
    """Start every path 15 subprocess at once; {name: (Popen, log path)}."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in dry_jobs(out).items():
        logf = open(os.path.join(out, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(argv, cwd=HERE, env=env,
                                        stdout=logf, stderr=subprocess.STDOUT),
                       logf)
    return procs


def join_dry_jobs(procs, out, deadline):
    """Wait for every job (killing all past the deadline); their logs."""
    logs = {}
    try:
        for name, (proc, logf) in procs.items():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for name, (proc, logf) in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
            with open(os.path.join(out, f"{name}.log")) as f:
                logs[name] = f.read()
    for name, (proc, _) in procs.items():
        check(proc.returncode == 0, f"path 15: {name} exited "
              f"{proc.returncode}:\n{logs[name][-3000:]}")
    return logs


def dry_record(out, cell):
    with open(os.path.join(out, cell + ".json")) as f:
        return json.load(f)


def dryrun_path(torch, mods, p14a, p14b, counters, beside=None):
    """Path 15 (the module docstring, phase 36). ``beside()``, if given,
    runs while the trace jobs finish (host-bound work of path 16 (b): the
    traces leave cores idle once the short ones are done). Returns (result
    dict, K5 / K6 / aggregate launches of (c)'s real steps, the records of
    path 16's cuts, ``beside()``'s return value)."""
    (sh, analyze_step, phi_step, phi_args, make_mesh, init_opt_state) = mods
    import tempfile
    import torch.distributed as dist
    from repro_torch.parallel.context import Mesh
    t_wall = time.perf_counter()
    out = tempfile.mkdtemp(prefix="qpad-path15-")
    res = {"cells": {}, "peak_rtol": DRY_PEAK_RTOL}
    try:
        procs = start_dry_jobs(out)
        deadline = time.perf_counter() + DRY_TIMEOUT_S
        launched = {}
        # (c), the real half: the SMOKE steps on the card, a (1, 1) mesh
        # record (size-1 axes run no collective, so no process group)
        mesh11 = Mesh(axis="data", size=1, rank=0, group=None,
                      backend="nccl", device=torch.device("cuda"),
                      names=("data", "model"), dims=(1, 1))
        real_c = {}
        for name, (arch, cell, cfg) in dry_smoke_cases().items():
            args = dry_real_args(torch, name, arch, cell, cfg)
            blocks = sh.shard_tree(mesh11, args, arch.arg_specs(cell,
                                                                mesh11))
            del args
            r = analyze_step(arch.step_fn(cell, mesh11), blocks, mesh11)
            torch.cuda.synchronize()
            r.pop("out")
            real_c[name] = r
            del blocks
        for k in ("flash_attention_fwd", "fused_ce_fwd", "csr_gather_sum"):
            launched[k] = sum(r["launches"][k] for r in real_c.values())
        # (d), the real half: one MPAD iteration at world 1 over NCCL
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh1 = make_mesh((1,), ("data",), backend="nccl")
        try:
            g = torch.Generator(device="cuda").manual_seed(SEED + 16)
            n, dim, m = 1 << 20, 1024, 128
            args = tuple(torch.randn(a.shape, generator=g, device="cuda")
                         for a in phi_args(n, dim, m, 1, "meta"))
            args[3].copy_((args[3] > 0).float())
            r = analyze_step(phi_step(mesh1, n), args, mesh1)
            torch.cuda.synchronize()
            real_d = {"dot_flops": r["dot_flops"],
                      "coll_total": r["coll_total"],
                      "coll_counts": r["coll_counts"],
                      "tracked_peak_bytes": r["peak_bytes"],
                      "max_memory_allocated": torch.cuda.max_memory_allocated()
                      - base}
            del args, r
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        beside_out = None if beside is None else beside()
        logs = join_dry_jobs(procs, out, deadline)
        res["jobs_wall_s"] = time.perf_counter() - t_wall

        # (a) the production cells
        for arch, cell, mesh in DRY_CELLS:
            tags = {"single": ["pod_16x16"], "multi": ["multipod_2x16x16"],
                    "both": ["pod_16x16", "multipod_2x16x16"]}[mesh]
            for tag in tags:
                rec = dry_record(out, f"{tag}.{arch}.{cell}")
                check(rec["status"] == "ok", f"path 15 (a): {rec['cell']} "
                      f"{rec['status']}: {rec.get('error')}")
                keep = {k: rec[k] for k in (
                    "status", "n_devices", "model_flops", "flops",
                    "bytes_accessed", "memory", "collectives", "launches",
                    "trace_s", "device")}
                res["cells"][rec["cell"]] = keep
                mem = rec["memory"]
                ratio = rec["flops"] * rec["n_devices"] / rec["model_flops"]
                log(f"[path 15] (a) {rec['cell']}: {rec['status']}, args "
                    f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB a rank, "
                    f"predicted peak {mem['peak_memory_in_bytes'] / 1e9:.2f}"
                    f" GB, FLOPs {rec['flops']:.3e} a rank against "
                    f"model_flops {rec['model_flops']:.3e} "
                    f"({rec['n_devices']} ranks: "
                    f"{ratio:.2f}x), collectives "
                    + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                                rec["collectives"].items()
                                if k not in ("total", "counts") and v)
                    + f"; traced in {rec['trace_s']} s")

        # (b) against this run's path 14
        tag_a = (f"mesh_1x1.granite-moe-1b-a400m@batch={TRAIN_BATCH},"
                 f"seq={TRAIN_SEQ}.train_4k")
        ra = dry_record(out, tag_a)
        check(ra["status"] == "ok", f"path 15 (b): {ra.get('error')}")
        want_args = sum(p14a["argument_bytes"].values())
        got_args = ra["memory"]["argument_size_in_bytes"]
        peak_a, real_peak = (ra["memory"]["peak_memory_in_bytes"],
                             p14a["peak_mem_bytes"])
        res["b_cut_a"] = {
            "argument_bytes": got_args, "real_argument_bytes": want_args,
            "real_argument_parts": p14a["argument_bytes"],
            "launches": ra["launches"], "predicted_peak_bytes": peak_a,
            "real_peak_bytes": real_peak,
            "peak_rel": (peak_a - real_peak) / real_peak,
            "flops": ra["flops"], "collectives": ra["collectives"]}
        log(f"[path 15] (b) (1, 1) cut: argument bytes {got_args} (path 14 "
            f"(a)'s blocks and int32 batch {want_args}), K5 "
            f"{ra['launches']['flash_attention_fwd']} / K6 "
            f"{ra['launches']['fused_ce_fwd']} a step, predicted peak "
            f"{peak_a / 1e9:.3f} GB against path 14 (a)'s "
            f"max_memory_allocated {real_peak / 1e9:.3f} GB "
            f"({res['b_cut_a']['peak_rel']:+.2%})")
        check(got_args == want_args, f"path 15 (b): argument bytes "
              f"{got_args}, the real blocks' {want_args}")
        check(ra["launches"]["flash_attention_fwd"] == 48
              and ra["launches"]["fused_ce_fwd"] == 4,
              f"path 15 (b): launches {ra['launches']}")
        check(abs(res["b_cut_a"]["peak_rel"]) <= DRY_PEAK_RTOL,
              f"path 15 (b): predicted peak {peak_a} against {real_peak}")
        tag_b = (f"mesh_{'x'.join(map(str, SHARD_MESH))}.granite-moe-1b-"
                 f"a400m@batch={SHARD_B_BATCH},seq={SHARD_B_SEQ},layers="
                 f"{SHARD_B_LAYERS},capacity_factor=4.0.train_4k")
        rb = dry_record(out, tag_b)
        rb_meta = dry_record(out + "_meta", tag_b)
        check(rb["status"] == "ok" and rb_meta["status"] == "ok",
              f"path 15 (b): {rb.get('error')} {rb_meta.get('error')}")
        measured = p14b["ranks"][0]["collective_bytes_per_step"]
        traced = {k.replace("-", "_"): v for k, v in
                  rb["collectives"].items() if k not in ("total", "counts")}
        res["b_cut_b"] = {"traced": traced, "measured_rank0": measured,
                          "launches": rb["launches"],
                          "meta_equal": dry_reading(rb) ==
                          dry_reading(rb_meta),
                          "predicted_peak_bytes": rb["memory"][
                              "peak_memory_in_bytes"],
                          "real_peak_gb_rank0": p14b["ranks"][0][
                              "peak_mem_gb"]}
        log(f"[path 15] (b) (2, 2) cut: bytes a rank a step by kind "
            f"{traced} against path 14 (b)'s {measured}; K5 "
            f"{rb['launches']['flash_attention_fwd']} / K6 "
            f"{rb['launches']['fused_ce_fwd']}; meta trace equal: "
            f"{res['b_cut_b']['meta_equal']}")
        for kind, v in measured.items():
            check(traced[kind] == v, f"path 15 (b): {kind} traced "
                  f"{traced[kind]}, measured {v}")
        check(traced["reduce_scatter"] == 0
              and traced["collective_permute"] == 0,
              f"path 15 (b): {traced}")
        check(rb["launches"]["flash_attention_fwd"] == 2 * SHARD_B_LAYERS
              and rb["launches"]["fused_ce_fwd"] == 1,
              f"path 15 (b): launches {rb['launches']}")
        check(res["b_cut_b"]["meta_equal"], "path 15 (b): the meta trace "
              "differs from the fake CUDA one")

        # (c) SMOKE: fake against real
        line = next(ln for ln in logs["smoke"].splitlines()
                    if ln.startswith('{"dryrun_smoke"'))
        fake_c = json.loads(line)["dryrun_smoke"]
        res["c"] = {}
        for name, r in real_c.items():
            real = {"flops": r["dot_flops"], "bytes": r["bytes"],
                    "argument_bytes": r["argument_bytes"],
                    "launches": r["launches"]}
            fr = dry_reading(fake_c[name])
            fake = {k: fr[k] for k in real}
            res["c"][name] = {"real": real, "fake": fake,
                              "equal": real == fake}
            log(f"[path 15] (c) {name} SMOKE: FLOPs real {real['flops']:.6e}"
                f" fake {fake['flops']:.6e}, bytes {real['bytes']:.6e} / "
                f"{fake['bytes']:.6e}, launches real "
                f"{[real['launches'][k] for k in launched]} fake "
                f"{[fake['launches'][k] for k in launched]}")
            check(real == fake, f"path 15 (c) {name}: {real} against {fake}")

        # (d) MPAD at world 1
        with open(os.path.join(out, "mpad_world1.json")) as f:
            fd = json.load(f)
        peak_rel = (fd["peak_mem_dev"] - real_d["max_memory_allocated"]) \
            / real_d["max_memory_allocated"]
        res["d"] = {"fake": fd, "real": real_d, "peak_rel": peak_rel}
        log(f"[path 15] (d) dryrun_mpad world 1, N 2^20 x 1024: FLOPs fake "
            f"{fd['dot_flops_dev']:.6e} real {real_d['dot_flops']:.6e}; "
            f"collective bytes {fd['coll_bytes_dev']} / "
            f"{real_d['coll_total']}; peak fake {fd['peak_mem_dev'] / 1e9:.3f}"
            f" GB, real max_memory_allocated "
            f"{real_d['max_memory_allocated'] / 1e9:.3f} GB ({peak_rel:+.2%})")
        check(fd["dot_flops_dev"] == real_d["dot_flops"]
              and fd["coll_bytes_dev"] == real_d["coll_total"],
              f"path 15 (d): {fd} against {real_d}")
        check(abs(peak_rel) <= DRY_PEAK_RTOL, f"path 15 (d): peak "
              f"{fd['peak_mem_dev']} against {real_d}")

        # (e) olmoe-1b-7b on four cards
        res["e"] = {}
        for shape in DRY_FOUR_CARDS:
            rec = dry_record(out, f"mesh_{shape}.olmoe-1b-7b@batch="
                             f"{TRAIN_BATCH},seq={TRAIN_SEQ}.train_4k")
            check(rec["status"] == "ok", f"path 15 (e): {rec.get('error')}")
            peak = rec["memory"]["peak_memory_in_bytes"]
            res["e"][shape] = {
                "argument_bytes": rec["memory"]["argument_size_in_bytes"],
                "predicted_peak_bytes": peak,
                "fits_80gb": peak <= CARD_BYTES,
                "collectives": rec["collectives"]}
            log(f"[path 15] (e) olmoe-1b-7b at {TRAIN_BATCH} x {TRAIN_SEQ} "
                f"on a {shape} mesh: arguments "
                f"{rec['memory']['argument_size_in_bytes'] / 1e9:.2f} GB a "
                f"rank, predicted peak {peak / 1e9:.2f} GB against 80 GB")
        line = next(ln for ln in logs["serve"].splitlines()
                    if ln.startswith('{"dryrun_serve"'))
        serve_dry = json.loads(line)["dryrun_serve"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out + "_meta", ignore_errors=True)
    res["wall_s"] = time.perf_counter() - t_wall
    log(f"[path 15] wall {res['wall_s']:.1f} s")
    return res, launched, serve_dry, beside_out


def serve_b_config(name, layers):
    """Path 16 (b)'s cut of arch ``name``: its published config at
    ``layers`` layers, K5, granite at capacity_factor E / K."""
    from repro_torch.configs.registry import config_module
    cfg = dataclasses.replace(config_module(name).CONFIG, n_layers=layers,
                              attn_impl="flash")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def serve_dry_cuts():
    """Path 16's dry-run cuts: {name: (arch, shape, mesh shape, cut)}:
    (a)'s two cells at one (16, 16) rank's share on (1, 1), and each (b)
    case's prefill (its prompt: a prefill's collectives do not read the
    cache) and decode (SERVE_B_SLOTS slots) on its mesh."""
    cuts = {"a_prefill": ("tinyllama-1.1b", "prefill_32k", (1, 1),
                          dict(batch=SERVE_PREFILL_BATCH, seq=SERVE_SEQ)),
            "a_decode": ("tinyllama-1.1b", "decode_32k", (1, 1),
                         dict(batch=SERVE_DECODE_BATCH, seq=SERVE_SEQ))}
    for name, shape, layers, batch, prompt in SERVE_B_CASES:
        cut = dict(batch=batch, layers=layers)
        if name == "granite-moe-1b-a400m":
            cut["capacity_factor"] = 4.0
        cuts[f"b_prefill_{name}"] = (name, "prefill_32k", shape,
                                     dict(cut, seq=prompt))
        cuts[f"b_decode_{name}"] = (name, "decode_32k", shape,
                                    dict(cut, seq=SERVE_B_SLOTS))
    return cuts


def serve_dry_records(device="cuda"):
    """Path 16 (d)'s fake traces: rank 0 of each ``serve_dry_cuts`` cut on
    fake ``device`` tensors, {name: dry-run record}."""
    from repro_torch.launch.dryrun import cut_arch, run_cell
    out = {}
    for key, (name, shape, mesh, cut) in serve_dry_cuts().items():
        arch = cut_arch(name, shape=shape, **cut)
        out[key] = run_cell(name, shape, mesh, None, 0, device, arch=arch,
                            verbose=False)
    return out


def dryrun_serve():
    """``--dryrun-serve``: ``serve_dry_records`` as one JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    print(json.dumps({"dryrun_serve": serve_dry_records()}))
    return 0


def serve_reference(torch, tf, shape_config, name, layers, batch, prompt,
                    path):
    """Path 16 (b)'s one-process reference of one case on the card: the
    prefill of a seeded prompt into SERVE_B_SLOTS slots, its cache, then
    SERVE_B_STEPS greedy decode steps (the tokens fed and each step's
    logits), saved to ``path``."""
    cfg = serve_b_config(name, layers)
    params = tf.lm_init_params(cfg, seed=SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 161)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                         device="cuda", dtype=torch.int32)
    cache = tf.init_cache(cfg, batch, SERVE_B_SLOTS)
    logits, cache = tf.lm_prefill(params, cfg, toks, cache)
    kept = [{k: t.clone() for k, t in run.items()} for run in cache]
    dcfg = shape_config(cfg, "decode")
    tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
    fed, steps = [], []
    for i in range(SERVE_B_STEPS):
        fed.append(tok)
        logits_i, cache = tf.lm_decode_step(params, dcfg, tok, prompt + i,
                                            cache)
        steps.append(logits_i.float())
        tok = logits_i[:, :cfg.vocab].argmax(-1).to(torch.int32)
    torch.save({"prompt": toks, "cache": kept, "prefill_logits": logits,
                "fed": torch.stack(fed, 1), "logits": torch.stack(steps)},
               path)
    torch.cuda.synchronize()
    del params, cache, kept


def serve_mesh_rank(mesh22, tmp):
    """One gloo rank of path 16 (b) on the card: each SERVE_B_CASES case on
    its mesh (the (2, 2) mesh the ranks were started on, or a (1, 4) one
    built over the same world), from this rank's blocks of the case's
    parameters (every rank draws them from SEED on the card, as the
    reference did): the prefill through ``make_sharded_prefill`` with the
    bytes it puts into each collective kind and its K5 launches, its cache
    blocks against the reference's, then the decode steps through
    ``make_sharded_decode_step`` fed the reference's tokens, the logits
    put together from the blocks against one process's
    ``lm_decode_step`` from the ranks' own prefill cache (the merge alone:
    granite's EP prefill rounds its experts otherwise than one process's
    dispatch) and against the reference's. Returns every rank's
    readings."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import shape_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import step as pstep
    out = {}
    for name, shape, layers, batch, prompt in SERVE_B_CASES:
        mesh = mesh22 if tuple(shape) == tuple(mesh22.dims) else make_mesh(
            shape, ("data", "model"), backend="gloo", device=mesh22.device)
        ref = torch.load(os.path.join(tmp, f"{name}.pt"),
                         map_location=mesh.device)
        cfg = serve_b_config(name, layers)
        pspec = sh.lm_param_specs(cfg)
        cspec = sh.lm_cache_specs(cfg, mesh, batch, SERVE_B_SLOTS)
        b_ax = cspec[0]["k"][1]
        full_params = tf.lm_init_params(cfg, seed=SEED)
        params = sh.shard_tree(mesh, full_params, pspec)
        cache = sh.shard_tree(mesh, tf.init_cache(cfg, batch, SERVE_B_SLOTS),
                              cspec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill = pstep.make_sharded_prefill(cfg, mesh, pspec, cspec)
        n5 = fa.flash_attention_fwd.launches
        bf16 = fa.flash_attention_fwd.launches_by_route["mma_bf16"]
        t0 = time.perf_counter()
        with ctx.count_collectives() as c_pre:
            logits, cache = prefill(params, sh.rank_block(
                mesh, ref["prompt"], sh.P(b_ax, None)), cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        k5 = (fa.flash_attention_fwd.launches - n5,
              fa.flash_attention_fwd.launches_by_route["mma_bf16"] - bf16)
        want = sh.shard_tree(mesh, ref["cache"], cspec)
        blocks = {}
        for (key, got), (_, w) in zip(_keyed(cache), _keyed(want)):
            blocks[key] = {"bit_equal": bool(torch.equal(got, w)),
                           "rel_l2": rel_l2(torch, got.float(), w.float())
                           if got.is_floating_point() else 0.0}
        pre_full = sh.gather_blocks(mesh, logits, sh.P(b_ax, "model"))
        pre_diff = float((pre_full.float() - ref["prefill_logits"].float())
                         .abs().max())
        # the merge alone: one process decodes from the ranks' own prefill
        # cache (put together), fed the same tokens
        one_cache = sh.gather_tree(mesh, cache, cspec)
        dcfg = shape_config(cfg, "decode")
        decode = pstep.make_sharded_decode_step(dcfg, mesh, pspec, cspec)
        diffs, diffs_ref, agree, step_ms, c_steps = [], [], [], [], []
        for i in range(SERVE_B_STEPS):
            tok = sh.rank_block(mesh, ref["fed"][:, i], sh.P(b_ax))
            cur = torch.tensor(prompt + i, dtype=torch.int32,
                               device=mesh.device)
            t0 = time.perf_counter()
            with ctx.count_collectives() as c_dec:
                logits, cache = decode(params, tok, cur, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            c_steps.append(dict(c_dec.bytes))
            full = sh.gather_blocks(mesh, logits, sh.P(b_ax, "model")).float()
            one, one_cache = tf.lm_decode_step(full_params, dcfg,
                                               ref["fed"][:, i], prompt + i,
                                               one_cache)
            diffs.append(float((full - one.float()).abs().max()))
            diffs_ref.append(float((full - ref["logits"][i]).abs().max()))
            agree.append(float((full[:, :cfg.vocab].argmax(-1)
                                == one[:, :cfg.vocab].argmax(-1)).float()
                               .mean()))
            check(bool(torch.isfinite(full).all()), f"path 16 (b) {name}: "
                  f"non-finite logits at step {i}")
        out[name] = {
            "mesh": list(shape), "rank": mesh.rank,
            "coords": mesh.coords, "prefill_ms": pre_ms,
            "decode_step_ms": step_ms,
            "collective_bytes_prefill": dict(c_pre.bytes),
            "collective_calls_prefill": dict(c_pre.calls),
            "collective_bytes_decode_step": c_steps[0],
            "decode_steps_alike": all(c == c_steps[0] for c in c_steps),
            "k5_launches_prefill": k5[0], "k5_bf16_prefill": k5[1],
            "cache_blocks": blocks,
            "prefill_logits_max_abs_diff": pre_diff,
            "decode_logits_max_abs_diff": diffs,
            "decode_logits_max_abs_diff_vs_reference": diffs_ref,
            "greedy_agreement": float(np.mean(agree)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, full_params, cache, one_cache, want, ref, prefill, \
            decode, logits, full, one
        torch.cuda.empty_cache()
    every = [None] * mesh22.size
    dist.all_gather_object(every, out)
    return every


def serve_b(torch, tf, shape_config, run_ranks, smi):
    """Path 16 (b): the one-process references (``serve_reference``), then
    4 gloo ranks on cuda:0 (``serve_mesh_rank``), then the gates. Returns
    (result dict, each rank's K5 launches by case)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="qpad-path16-")
    t_wall = time.perf_counter()
    out = {"note": "gloo on one card (every collective staged through "
                   "host memory), run beside path 15's trace jobs: not a "
                   "deployment's number", "card": smi,
           "slots": SERVE_B_SLOTS, "steps": SERVE_B_STEPS, "cases": {}}
    try:
        t0 = time.perf_counter()
        for name, _, layers, batch, prompt in SERVE_B_CASES:
            serve_reference(torch, tf, shape_config, name, layers, batch,
                            prompt, os.path.join(tmp, f"{name}.pt"))
            torch.cuda.empty_cache()
        out["reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(serve_mesh_rank, (2, 2), (tmp,), device="cuda",
                          axis=("data", "model"), timeout=900)
        out["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k5 = {}
    for name, shape, layers, batch, prompt in SERVE_B_CASES:
        per = [r[name] for r in ranks]
        atol = SERVE_B_LOGIT_ATOL * (layers / 22) ** 0.5
        moe = name == "granite-moe-1b-a400m"
        bit = all(b["bit_equal"] for r in per
                  for b in r["cache_blocks"].values())
        worst_rel = max(b["rel_l2"] for r in per
                        for b in r["cache_blocks"].values())
        diff = max(max(r["decode_logits_max_abs_diff"]) for r in per)
        diff_ref = max(max(r["decode_logits_max_abs_diff_vs_reference"])
                       for r in per)
        agree = min(r["greedy_agreement"] for r in per)
        k5[name] = [r["k5_launches_prefill"] for r in per]
        out["cases"][name] = {
            "mesh": list(shape), "layers": layers, "batch": batch,
            "prompt": prompt, "ranks": per,
            "cache_bit_equal": bit, "cache_worst_rel_l2": worst_rel,
            "decode_logits_max_abs_diff": diff, "logits_atol": atol,
            "decode_logits_max_abs_diff_vs_reference": diff_ref,
            "greedy_agreement": agree}
        log(f"[path 16] (b) {name} {layers} layers on {shape} gloo ranks, "
            f"batch {batch}, prompt {prompt} into {SERVE_B_SLOTS} slots: "
            f"prefill {[round(r['prefill_ms'], 1) for r in per]} ms a rank,"
            f" decode {[round(float(np.median(r['decode_step_ms'])), 1) for r in per]}"
            f" ms a step (p50); cache blocks bit-equal {bit} (worst rel "
            f"L2 {worst_rel:.3e}); decode logits max |diff| {diff:.4f} "
            f"(bound {atol:.4f}) against one process from the ranks' cache, "
            f"{diff_ref:.4f} against the reference's prefill and decode; "
            f"greedy agreement {agree:.3f}; rank 0's "
            f"collective bytes: prefill "
            f"{ {k: v for k, v in per[0]['collective_bytes_prefill'].items() if v} }"
            f", a decode step "
            f"{ {k: v for k, v in per[0]['collective_bytes_decode_step'].items() if v} }"
            f"; K5 {k5[name]} a rank; peak "
            f"{[round(r['peak_mem_gb'], 2) for r in per]} GB")
        check(all(r["k5_launches_prefill"] == layers
                  and r["k5_bf16_prefill"] == layers for r in per),
              f"path 16 (b) {name}: K5 launches {k5[name]}, want {layers} "
              "a rank on the bf16 route")
        check(all(r["decode_steps_alike"] for r in per),
              f"path 16 (b) {name}: decode steps moved different bytes")
        check(bit or (moe and worst_rel <= SERVE_B_MOE_REL),
              f"path 16 (b) {name}: cache blocks differ from one process's "
              f"(worst rel L2 {worst_rel:.3e})")
        check(diff <= atol, f"path 16 (b) {name}: decode logits differ by "
              f"{diff} > {atol}")
        check(agree >= LM_AGREE_FLOOR, f"path 16 (b) {name}: greedy "
              f"agreement {agree} < {LM_AGREE_FLOOR}")
    out["wall_s"] = time.perf_counter() - t_wall
    return out, k5


def serve_a(torch, mods, base_cfg, counters):
    """Path 16 (a): ``base_cfg`` (TinyLlama-1.1B) on a (1, 1) NCCL mesh at
    one production rank's share of prefill_32k and decode_32k (the module
    docstring, phase 37). Returns (result dict, K5 launches on the main
    runs, K5's max |err| at the path's shape, K5 timing dict)."""
    (tf, fa, sh, pstep, make_mesh, shape_config, lm_param_count,
     tensor_bytes, rms_norm) = mods
    import torch.distributed as dist
    cfg = dataclasses.replace(base_cfg, attn_impl="flash")
    dcfg = shape_config(cfg, "decode")
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "mesh": [1, 1],
           "backend": "nccl"}
    g = torch.Generator(device="cuda").manual_seed(SEED + 160)

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), backend="nccl")
    try:
        pspec = sh.lm_param_specs(cfg)
        params = sh.shard_tree(mesh, tf.lm_init_params(cfg, seed=SEED),
                               pspec)
        torch.cuda.synchronize()
        # prefill_32k at one rank's share: counts zeroed just before
        cspec = sh.lm_cache_specs(cfg, mesh, SERVE_PREFILL_BATCH, SERVE_SEQ)
        prefill = pstep.make_sharded_prefill(cfg, mesh, pspec, cspec)
        tokens = ints(cfg.vocab, SERVE_PREFILL_BATCH, SERVE_SEQ)
        cache = tf.init_cache(cfg, SERVE_PREFILL_BATCH, SERVE_SEQ)
        args = (params, tokens, cache)
        out["prefill_argument_bytes"] = tensor_bytes(args)
        for fn in counters:
            fn.launches = 0
        fa.flash_attention_fwd.launches_by_route = dict.fromkeys(fa.ROUTES,
                                                                 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = prefill(*args)
        torch.cuda.synchronize()
        out["first_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                     - base + out["prefill_argument_bytes"])
        launches = fa.flash_attention_fwd.launches
        routes = dict(fa.flash_attention_fwd.launches_by_route)
        others = {fn.__name__: fn.launches for fn in counters
                  if fn is not fa.flash_attention_fwd}
        check(launches == cfg.n_layers and routes["mma_bf16"] == launches,
              f"path 16 (a): K5 launched {launches} times ({routes}) in the "
              f"prefill, want {cfg.n_layers} on mma_bf16")
        check(not any(others.values()), f"another kernel ran on path 16 "
              f"(a): {others}")
        ref_cache = tf.init_cache(cfg, SERVE_PREFILL_BATCH, SERVE_SEQ)
        ref_logits, ref_cache = tf.lm_prefill(params, cfg, tokens, ref_cache)
        pre_equal = bool(torch.equal(logits, ref_logits)) and all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(_keyed(cache), _keyed(ref_cache)))
        del ref_cache, ref_logits
        t0 = time.perf_counter()
        prefill(params, tokens, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        n_tok = SERVE_PREFILL_BATCH * SERVE_SEQ
        # K5 at the path's shape: layer 0's q, k, v of these tokens
        lp0 = {key: t[0] for key, t in params["runs"][0].items()
               if not isinstance(t, dict)}
        with torch.inference_mode():
            x = rms_norm(params["embed"][tokens].to(cfg.dtype), lp0["ln1"])
            q, k, v = tf._qkv(cfg, x, lp0, torch.arange(SERVE_SEQ,
                                                        device="cuda"), None)
        del x
        out["k5_check"] = {}
        k5_err = compare_k5(torch, fa, "K5 path 16 bf16 B=2 S=32768", q, k,
                            v, None, out["k5_check"])
        k5 = k5_timing(torch, fa, q, k, v, plain_reps=1)
        del q, k, v
        model_flops = (2 * lm_param_count(cfg) * n_tok
                       + cfg.n_layers * k5["ops"])
        out.update({
            "prefill": {"batch": SERVE_PREFILL_BATCH, "seq": SERVE_SEQ,
                        "bit_equal": pre_equal, "ms": pre_ms,
                        "tok_per_s": n_tok / (pre_ms / 1e3),
                        "model_flops": model_flops,
                        "peak_share": model_flops / (pre_ms / 1e3)
                        / BF16_OPS_PER_S,
                        "k5_launches": launches, "k5_by_route": routes}})
        log(f"[path 16] (a) prefill {SERVE_PREFILL_BATCH} x {SERVE_SEQ} on a "
            f"(1, 1) NCCL mesh: {out['first_prefill_ms']:.1f} ms first, "
            f"{pre_ms:.1f} ms second, {out['prefill']['tok_per_s']:.0f} "
            f"tok/s ({out['prefill']['peak_share']:.4f} of the bf16 peak); "
            f"bit-equal to lm_prefill: {pre_equal}; K5 {launches} "
            f"launches; peak {out['prefill_peak_bytes'] / 1e9:.3f} GB "
            f"(arguments {out['prefill_argument_bytes'] / 1e9:.3f})")
        check(pre_equal, "path 16 (a): the prefill rank program is not "
              "lm_prefill bit for bit")
        del cache, tokens, args, logits
        torch.cuda.empty_cache()

        # decode_32k at one rank's share: a prefill fills the cache, then
        # SERVE_DECODE steps through the rank program beside lm_decode_step
        cspec = sh.lm_cache_specs(cfg, mesh, SERVE_DECODE_BATCH, SERVE_SEQ)
        prefill = pstep.make_sharded_prefill(cfg, mesh, pspec, cspec)
        decode = pstep.make_sharded_decode_step(dcfg, mesh, pspec, cspec)
        fill = ints(cfg.vocab, SERVE_DECODE_BATCH, SERVE_FILL)
        cache = tf.init_cache(cfg, SERVE_DECODE_BATCH, SERVE_SEQ)
        n0 = fa.flash_attention_fwd.launches
        t0 = time.perf_counter()
        logits, cache = prefill(params, fill, cache)
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        fill_k5 = fa.flash_attention_fwd.launches - n0
        launches += fill_k5
        del fill
        ref_cache = [{k: t.clone() for k, t in run.items()} for run in cache]
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        equal, step_ms = True, []
        for i in range(SERVE_DECODE):
            cur = torch.tensor(SERVE_FILL + i, dtype=torch.int32,
                               device="cuda")
            if i == 0:
                args = (params, tok, cur, cache)
                out["decode_argument_bytes"] = tensor_bytes(args)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            la, cache = decode(params, tok, cur, cache)
            e.record()
            torch.cuda.synchronize()
            step_ms.append(s.elapsed_time(e))
            if i == 0:
                out["decode_peak_bytes"] = (
                    torch.cuda.max_memory_allocated() - base
                    + out["decode_argument_bytes"])
            lb, ref_cache = tf.lm_decode_step(params, dcfg, tok,
                                              SERVE_FILL + i, ref_cache)
            equal = equal and bool(torch.equal(la, lb))
            tok = la[:, :cfg.vocab].argmax(-1).to(torch.int32)
        equal = equal and all(torch.equal(a, b) for (_, a), (_, b) in
                              zip(_keyed(cache), _keyed(ref_cache)))
        del ref_cache
        check(fa.flash_attention_fwd.launches - n0 == cfg.n_layers,
              "path 16 (a): K5 ran in a decode step")
        cur = torch.tensor(SERVE_SEQ - 1, dtype=torch.int32, device="cuda")
        busy = busy_share(torch, lambda: decode(params, tok, cur, cache), 10,
                          "path 16 (a) decode")
        p50 = float(np.median(step_ms))
        out["decode"] = {
            "batch": SERVE_DECODE_BATCH, "slots": SERVE_SEQ,
            "fill_tokens": SERVE_FILL, "steps": SERVE_DECODE,
            "bit_equal": equal, "fill_prefill_ms": fill_ms,
            "fill_k5_launches": fill_k5,
            "step_ms": {"p50": p50, "p90": float(np.percentile(step_ms, 90)),
                        "first": step_ms[0]},
            "tok_per_s": SERVE_DECODE_BATCH / (p50 / 1e3), "busy": busy}
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[path 16] (a) decode {SERVE_DECODE_BATCH} rows over "
            f"{SERVE_SEQ} slots (filled by {SERVE_FILL} tokens in "
            f"{fill_ms:.1f} ms): p50 {p50:.3f} ms a step (first "
            f"{step_ms[0]:.3f}), {out['decode']['tok_per_s']:.1f} tok/s, "
            f"busy {busy['busy_share']:.3f}; bit-equal to lm_decode_step "
            f"over {SERVE_DECODE} steps: {equal}; peak "
            f"{out['decode_peak_bytes'] / 1e9:.3f} GB a step (arguments "
            f"{out['decode_argument_bytes'] / 1e9:.3f})")
        check(equal, "path 16 (a): the decode rank program is not "
              "lm_decode_step bit for bit")
        del cache, params, logits, la, lb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out, launches, k5_err, k5


def serve_c(torch, mods, gemma_cfg, smi):
    """Path 16 (c): gemma3-4b long_500k at full size on a (1, 1) NCCL mesh:
    LONG_SLOTS slots seeded with K / V and positions up to LONG_SLOTS -
    LONG_STEPS, then LONG_STEPS decode steps through the rank program
    beside lm_decode_step on a copy. Returns the result dict."""
    tf, sh, pstep, make_mesh, shape_config, tensor_bytes = (
        mods[0], mods[2], mods[3], mods[4], mods[5], mods[7])
    import torch.distributed as dist
    cfg = dataclasses.replace(gemma_cfg, attn_impl="flash")
    dcfg = shape_config(cfg, "decode")
    cur0 = LONG_SLOTS - LONG_STEPS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, 1), ("data", "model"), backend="nccl")
    try:
        pspec = sh.lm_param_specs(cfg)
        cspec = sh.lm_cache_specs(cfg, mesh, 1, LONG_SLOTS)
        t0 = time.perf_counter()
        params = tf.lm_init_params(cfg, seed=SEED)
        g = torch.Generator(device="cuda").manual_seed(SEED + 162)
        cache = tf.init_cache(cfg, 1, LONG_SLOTS)
        for run in cache:
            run["k"].normal_(generator=g)
            run["v"].normal_(generator=g)
            s_run = run["pos"].shape[0]
            seen = torch.arange(max(0, cur0 - s_run), cur0, device="cuda",
                                dtype=torch.int32)
            run["pos"][seen.long() % s_run] = seen
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes, cache_bytes = tensor_bytes(params), tensor_bytes(cache)
        ref = [{k: t.clone() for k, t in run.items()} for run in cache]
        decode = pstep.make_sharded_decode_step(dcfg, mesh, pspec, cspec)
        tok = torch.randint(0, cfg.vocab, (1,), generator=g, device="cuda",
                            dtype=torch.int32)
        equal, step_ms = True, []
        for i in range(LONG_STEPS):
            cur = torch.tensor(cur0 + i, dtype=torch.int32, device="cuda")
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            la, cache = decode(params, tok, cur, cache)
            e.record()
            torch.cuda.synchronize()
            step_ms.append(s.elapsed_time(e))
            lb, ref = tf.lm_decode_step(params, dcfg, tok, cur0 + i, ref)
            equal = equal and bool(torch.equal(la, lb))
            check(bool(torch.isfinite(la).all()), "path 16 (c): non-finite "
                  "logits")
            tok = la[:, :cfg.vocab].argmax(-1).to(torch.int32)
        equal = equal and all(torch.equal(a, b) for (_, a), (_, b) in
                              zip(_keyed(cache), _keyed(ref)))
        peak = torch.cuda.max_memory_allocated() / 1e9
        del ref, cache, params, la, lb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    p50 = float(np.median(step_ms[1:]))
    bound = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    out = {"config": cfg.name, "mesh": [1, 1], "batch": 1,
           "slots": LONG_SLOTS, "cur": cur0, "steps": LONG_STEPS,
           "bit_equal": equal, "init_s": init_s, "step_ms": step_ms,
           "step_ms_p50": p50, "param_bytes": param_bytes,
           "cache_bytes": cache_bytes, "read_bound_ms": bound,
           "bound_share": bound / p50, "peak_mem_gb": peak, "card": smi}
    log(f"[path 16] (c) {cfg.name} long_500k: {LONG_SLOTS} slots, "
        f"{LONG_STEPS} decode steps from position {cur0}: p50 {p50:.2f} ms "
        f"a step (steps {[round(t, 2) for t in step_ms]}); read bound "
        f"{bound:.3f} ms (cache {cache_bytes / 1e9:.3f} GB + parameters "
        f"{param_bytes / 1e9:.3f} GB at the HBM rate); bit-equal to "
        f"lm_decode_step: {equal}; peak {peak:.2f} GB")
    check(equal, "path 16 (c): the decode rank program is not "
          "lm_decode_step bit for bit")
    return out


def serve_d(a, b, dry):
    """Path 16 (d): path 15's traces of (a)'s and (b)'s cuts
    (``serve_dry_cuts``, rank 0) against (a)'s real arguments, launches
    and peaks and (b)'s rank 0 counts. Returns the result dict."""
    out = {"peak_rtol": DRY_PEAK_RTOL}
    for key in dry:
        check(dry[key]["status"] == "ok", f"path 16 (d): {key} "
              f"{dry[key]['status']}: {dry[key].get('error')}")
    for phase in ("prefill", "decode"):
        rec = dry[f"a_{phase}"]
        got = rec["memory"]["argument_size_in_bytes"]
        want = a[f"{phase}_argument_bytes"]
        peak, real = (rec["memory"]["peak_memory_in_bytes"],
                      a[f"{phase}_peak_bytes"])
        out[f"a_{phase}"] = {"argument_bytes": got, "real_argument_bytes":
                             want, "predicted_peak_bytes": peak,
                             "real_peak_bytes": real,
                             "peak_rel": (peak - real) / real,
                             "launches": rec["launches"],
                             "collectives": rec["collectives"]}
        log(f"[path 16] (d) (a)'s {phase} cut: argument bytes {got} (real "
            f"{want}), predicted peak {peak / 1e9:.3f} GB against "
            f"{real / 1e9:.3f} GB ({out[f'a_{phase}']['peak_rel']:+.2%}), "
            f"K5 {rec['launches']['flash_attention_fwd']}")
        check(got == want, f"path 16 (d): {phase} argument bytes {got}, the "
              f"real blocks' {want}")
        check(abs(out[f"a_{phase}"]["peak_rel"]) <= DRY_PEAK_RTOL,
              f"path 16 (d): {phase} predicted peak {peak} against {real}")
    n5 = dry["a_prefill"]["launches"]["flash_attention_fwd"]
    want5 = a["prefill"]["k5_launches"]
    check(n5 == want5 == a["n_layers"] and dry["a_decode"]["launches"][
        "flash_attention_fwd"] == 0, f"path 16 (d): K5 {n5} in the prefill "
          f"trace (want {want5}, one a layer), "
          f"{dry['a_decode']['launches']['flash_attention_fwd']} in decode")
    for name, *_ in SERVE_B_CASES:
        r0 = b["cases"][name]["ranks"][0]
        for phase, real in (("prefill", r0["collective_bytes_prefill"]),
                            ("decode", r0["collective_bytes_decode_step"])):
            traced = {k: v for k, v in dry[f"b_{phase}_{name}"][
                "collectives"].items() if k not in ("total", "counts")}
            out[f"b_{phase}_{name}"] = {"traced": traced, "measured": real}
            log(f"[path 16] (d) (b) {name} {phase}: traced bytes by kind "
                f"{ {k: v for k, v in traced.items() if v} }, measured "
                f"{ {k: v for k, v in real.items() if v} }")
            check(traced == {k: float(v) for k, v in real.items()},
                  f"path 16 (d): {name} {phase} traced {traced}, measured "
                  f"{real}")
    return out


def serve_path(torch, mods, configs, counters, smi, b, dry):
    """Path 16 (phase 37): (a) on ``configs``' TinyLlama, (c) on its
    gemma3-4b, then (d) against path 15's traces of the cuts (``dry``) and
    (b) (``serve_b``'s (result dict, K5 launches), run beside path 15's
    trace jobs). Returns (result dict, K5 launches on (a)'s main runs,
    (b)'s K5 launches a rank by case, K5's max |err| at (a)'s shape, the
    K5 timing at (a)'s shape)."""
    tinyllama, gemma = configs
    t_wall = time.perf_counter()
    res = {"card": smi}
    res["a"], launches, k5_err, k5 = serve_a(torch, mods, tinyllama,
                                             counters)
    res["b"], k5_ranks = b
    res["c"] = serve_c(torch, mods, gemma, smi)
    res["d"] = serve_d(res["a"], res["b"], dry)
    res["wall_s"] = time.perf_counter() - t_wall + res["b"]["wall_s"]
    log(f"[path 16] wall {res['wall_s']:.1f} s ((b) {res['b']['wall_s']:.1f}"
        " s of it, beside path 15's trace jobs)")
    return res, launches, k5_ranks, k5_err, k5


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch._device import cpu_generator
        from repro_torch.core import MPADConfig, fast_objective
        from repro_torch.core.objective import num_selected_pairs
        from repro_torch.configs import lm_param_count
        from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mpad_pairwise as pw
        from repro_torch.kernels.pq_adc import ops, ref
        from repro_torch.kernels.pq_adc.lut import center_lut
        from repro_torch.search import ivfpq, knn
        from repro_torch.search import (SearchEngine, build_engine,
                                        recall_at_k)
        from repro_torch.search import ivf
        from repro_torch.search.ivf import probe_cells
        from repro_torch.search.pq import adc_tables
        from repro_torch.search.registry import (BuildInits, Index,
                                                 ScanParams, get_ops)
        from repro_torch.search.reducers import reduce_vectors
        from repro_torch.search.serve import (EngineState, config_from_spec,
                                              exact_rerank)
        from repro_torch.search import segments
        from repro_torch.search.segments import StreamConfig
        from repro_torch.search import durability, load_engine
        from repro_torch.search import (MetricsServer, render_prometheus,
                                        tracing)
        from repro_torch.search.durability import recovery
        from repro_torch.search.durability import wal as wal_mod
        from repro_torch._tree import tree_map
        from repro_torch.search.spec import parse_spec
        from repro_torch.models import transformer as tf
        from repro_torch.models.layers import rms_norm
        from repro_torch.configs.tinyllama_1_1b import SMOKE as TINY_SMOKE
        from repro_torch.kernels import fused_ce as fce
        from repro_torch.kernels import knn_topk
        from repro_torch import data, optim, runtime
        from repro_torch.configs import mpad_paper as paper
        from repro_torch.core import baselines, fit_mpad, objective
        from repro_torch.core import mpad as mpad_mod
        from repro_torch.core.distributed import (fit_mpad_sharded,
                                                  make_phi_dist)
        from repro_torch.launch.mesh import (make_mesh, make_serving_mesh,
                                             run_ranks)
        from repro_torch.parallel import sharding as psh
        from repro_torch.parallel import step as pstep
        from repro_torch.configs import recsys_family, shape_config
        from repro_torch.configs import (autoint, dien, sasrec,
                                         two_tower_retrieval)
        from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE
        from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
        from repro_torch.models import moe
        from repro_torch.models import recsys as rs
        from repro_torch.models.layers import chunked_attention
        from repro_torch.configs import gin_tu, gnn_family
        from repro_torch.data import graph as graph_data
        from repro_torch.kernels import graph_agg as ga
        from repro_torch.models import gnn
        from repro_torch.launch.step_analysis import (analyze_step,
                                                      tensor_bytes)
        from repro_torch.launch.dryrun_mpad import phi_args, phi_step
        from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall0 = time.perf_counter()
    result = {"spec": SPEC, "spec_pq": SPEC_PQ, "spec_opq": SPEC_OPQ,
              "n": N, "dim": DIM, "seed": SEED}

    # 1. device
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result["card"] = smi = card_line()

    # 2. build, path 12's graphs made on the host beside it and the edge
    # cases (no timed path runs until they are joined; the build's nvcc
    # processes share the host's cores with the thread)
    gnn_inputs = start_gnn_graphs(graph_data, gnn_family)
    t0 = time.perf_counter()
    build.build_libraries(verbose=True)
    result["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel libraries built in "
        f"{result['build_s']:.2f} s")

    # 3. each kernel on edge cases
    log("[K1 edges]")
    max_err = edge_cases(torch, ops, ref)
    log("[K2 edges]")
    k2_err = edge_cases_k2(torch, ops)
    log("[K1 cells edges]")
    max_err = max(max_err, edge_cases_k1_cells(torch, ops, ref))
    log("[K4 edges]")
    k4_err = edge_cases_k4(torch, pw, fast_objective, num_selected_pairs)
    log("[K5 edges]")
    k5_err, result["k5_edges"] = edge_cases_k5(torch, fa)
    log("[K6 edges]")
    k6_err = edge_cases_k6(torch, fce)
    log("[K3 edges]")
    k3_err = edge_cases_k3(torch, knn_topk)
    log("[aggregate edges]")
    agg_err = edge_cases_agg(torch, ga)
    torch.cuda.synchronize()
    gnn_graph_in, gen_s, gen_wait_s = gnn_inputs()
    log(f"[path 12] graphs made on the host in {gen_s:.1f} s beside the "
        f"build and the edge cases ({gen_wait_s:.1f} s waited after them)")

    # 4. the main path
    t0 = time.perf_counter()
    x = clustered_corpus(N, DIM, SEED)
    q_all = clustered_corpus(max(BATCHES), DIM, SEED + 1)
    log(f"[main] corpus {x.shape} made in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    xd = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(q_all).to(dev)
    del x
    counters = (ops.pq_adc_gather_topk, ops.pq_adc_cells_topk,
                ops.pq_adc_topk, pw.pairwise_stats,
                pw.pairwise_stats_at_quantile, fa.flash_attention_fwd,
                fce.fused_ce_fwd, knn_topk.knn_topk_d2, ga.csr_gather_sum)
    TRACED_KERNELS.extend((
        ("adc_select<", (ops.pq_adc_gather_topk, ops.pq_adc_cells_topk)),
        ("adc_shared_select<", (ops.pq_adc_topk,)),
        ("pair_partials", (pw.pairwise_stats,)),
        ("quantile_stats", (pw.pairwise_stats_at_quantile,)),
        ("flash_fwd", (fa.flash_attention_fwd,)),
        ("ce_partial", (fce.fused_ce_fwd,)),
        ("knn_select", (knn_topk.knn_topk_d2,)),
        ("csr_gather_sum", (ga.csr_gather_sum,))))
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    eng = build_engine(xd, SPEC, device=dev, seed=SEED)
    torch.cuda.synchronize()
    result["engine_build_s"] = time.perf_counter() - t0
    result["build_stages_s"] = eng.build_seconds
    lists = eng.state.index.payload.lists
    result["max_cell"] = int(lists.shape[1])
    log(f"[main] build_engine {result['engine_build_s']:.1f} s, stages "
        f"{ {k: round(v, 2) for k, v in eng.build_seconds.items()} }, "
        f"max_cell {result['max_cell']}")
    lat, found = search_timed(torch, eng, qd, BATCHES)
    k1_gathered = ops.pq_adc_gather_topk.launches
    k1_cells = ops.pq_adc_cells_topk.launches
    launches = k1_gathered + k1_cells
    result["latency"] = lat
    result["k1_launches"] = {"gathered": k1_gathered, "cells": k1_cells}
    log(f"[main] K1 launches in the main path: gathered entry "
        f"{k1_gathered}, cell-major entry {k1_cells}")
    check(k1_cells > 0, "K1's cell-major entry never launched on the main "
          "path")
    result["k1_entries"] = k1_entries(torch, ops, eng, qd, "path 1")
    _, truth = knn.knn_scan(qd, xd, K)
    rec = {b: recall_at_k(found[b], truth[:b]) for b in BATCHES}
    result["recall_at_10"] = rec
    for b in BATCHES:
        log(f"[main] batch {b:4d}: p50 {lat[b]['p50_ms']:.3f} ms "
            f"p90 {lat[b]['p90_ms']:.3f} ms qps {lat[b]['qps']:.0f} "
            f"recall@10 {rec[b]:.4f}")
    check(rec[256] >= RECALL_FLOOR, f"recall@10 {rec[256]} < {RECALL_FLOOR}")
    jeng = SearchEngine.from_state(
        eng.state, dataclasses.replace(eng.config, pq_backend="jnp"))
    _, ij = jeng.search(qd, K)
    check(torch.equal(ij, found[256]), "@jnp and @kernel ids differ")
    log("[main] @jnp returns the @kernel ids at batch 256")

    # 5. K1 against its plain version on the main path's scan inputs
    state = eng.state
    ix = state.index.payload
    cfg = eng.config
    qr = reduce_vectors(state.proj, qd)
    probe, cand, cd2p = probe_cells(ix.centroids, ix.lists, qr, cfg.nprobe,
                                    cfg.rerank)
    ccodes, base = ivfpq.ivfpq_scan_inputs(probe, cand, cd2p, ix.codes_cell,
                                           ix.bias_cell)
    tables = adc_tables(ix.lut_w, ix.cbnorm, qr)
    center, scale = ivfpq.ivfpq_lut_stats(ix.codebooks, ix.cbnorm, qr, "int8")
    kt = tables - center[:, :, None]
    k_eff = min(cfg.rerank, cand.shape[1])
    c = int(cand.shape[1])
    result["scan_shape"] = {"Q": 256, "C": c, "M": int(ix.codes_cell.shape[2]),
                            "K": int(ix.cbnorm.shape[1]), "k": k_eff}
    log(f"[K1 main] scan shape {result['scan_shape']}")
    for lut in ("f32", "bf16"):
        max_err = max(max_err, compare_k1(torch, ops, ref, f"main {lut}",
                                          tables, ccodes, base, k_eff, lut,
                                          None))
    max_err = max(max_err, compare_k1(torch, ops, ref, "main int8", kt,
                                      ccodes, base, k_eff, "int8", scale))
    cell_len = (ix.lists >= 0).sum(dim=1)
    cells_in = (probe, cd2p, ix.codes_cell, ix.bias_cell, cand)
    for lut in ("f32", "bf16"):
        max_err = max(max_err, compare_k1_cells(
            torch, ops, ref, f"main cells {lut}", tables, *cells_in, k_eff,
            lut, None, cell_len))
    max_err = max(max_err, compare_k1_cells(
        torch, ops, ref, "main cells int8", kt, *cells_in, k_eff, "int8",
        scale, cell_len))

    # 6. timings at batch 256 (int8, the main path's LUT): the gather and
    # both K1 entries on the main path's own scan, with their bounds
    k1t = k1_time(torch, ops, ivfpq, kt, scale, probe, cd2p, ix.codes_cell,
                  ix.bias_cell, cand, cell_len, k_eff)
    log_k1_time("timings", k1t)
    result["k1_timing"] = k1t
    result["l2_read_bytes_per_s"] = l2 = l2_read_rate(torch)
    k1t["bounds"]["cells"]["l2_ms"] = k1t["bounds"]["cells"]["l2_bytes"] / l2 * 1e3
    log(f"[timings] L2 read rate of a torch reduction on this card: "
        f"{l2 / 1e12:.3f} TB/s; the cell-major entry's L2 traffic at it "
        f"{k1t['bounds']['cells']['l2_ms']:.4f} ms; no single PyTorch call "
        "computes K1, so no library time")

    def stage(fn):
        return cuda_ms(torch, fn, reps=10)

    _, scan_cand = get_ops(cfg.index).scan(state, qr, cfg.rerank, ScanParams(
        nprobe=cfg.nprobe, backend="kernel", lut_dtype=cfg.lut_dtype))

    stages = {
        "project": stage(lambda: reduce_vectors(state.proj, qd)),
        "probe": stage(lambda: probe_cells(ix.centroids, ix.lists, qr,
                                           cfg.nprobe, cfg.rerank)),
        "lut": stage(lambda: (adc_tables(ix.lut_w, ix.cbnorm, qr),
                              ivfpq.ivfpq_lut_stats(ix.codebooks, ix.cbnorm,
                                                    qr, "int8"))),
        "gather (off the kernel path)": k1t["gather_ms"],
        "adc_k1_cells": k1t["cells_ms"],
        "adc_k1_gathered (off the kernel path)": k1t["gathered_ms"],
        "rerank": stage(lambda: exact_rerank(qd, state.corpus, scan_cand,
                                             K)),
    }
    result["stages_ms_batch256"] = stages
    log(f"[timings] stages at batch 256 (ms): "
        f"{ {k: round(v, 4) for k, v in stages.items()} }")

    # 7. device busy share of the search path (torch.profiler)
    result["device_busy"] = {b: device_busy(torch, eng, qd[:b], f"batch {b}")
                             for b in (1, 256)}

    # F2: k-means over path 1's reduced 1M x 64 vectors at its 1024 cells
    result["kmeans_repeat"] = kmeans_repeat(
        torch, ivf, reduce_vectors(state.proj, xd),
        int(ix.centroids.shape[0]), cpu_generator(SEED))

    # 8. path 2: pq with the QPAD fit on K4, then opq on the same reducer
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    eng_pq = build_engine(xd, SPEC_PQ, device=dev, seed=SEED,
                          fit_sample=FIT_SAMPLE,
                          mpad=MPADConfig(**FIT, backend="kernel"))
    torch.cuda.synchronize()
    result["pq_engine_build_s"] = time.perf_counter() - t0
    result["pq_build_stages_s"] = eng_pq.build_seconds
    k4_launches = pw.pairwise_stats_at_quantile.launches
    k4_unfused_launches = pw.pairwise_stats.launches
    result["k4_launches_fit"] = {"fused": k4_launches,
                                 "at_tau": k4_unfused_launches}
    log(f"[path 2] build_engine({SPEC_PQ}) "
        f"{result['pq_engine_build_s']:.1f} s, stages "
        f"{ {k: round(v, 2) for k, v in eng_pq.build_seconds.items()} }; "
        f"K4 launches in the fit: fused entry {k4_launches}, entry at a "
        f"given tau {k4_unfused_launches}")
    check(k4_launches == FIT["m"] * FIT["iters"] and
          k4_unfused_launches == 0,
          f"the kernel-backend fit launched K4's fused entry {k4_launches} "
          f"times and its entry at a given tau {k4_unfused_launches}, not "
          f"{FIT['m'] * FIT['iters']} and 0")
    check(ops.pq_adc_topk.launches == 0 and
          ops.pq_adc_gather_topk.launches == 0 and
          ops.pq_adc_cells_topk.launches == 0, "a scan kernel ran in a build")
    proj = eng_pq.state.proj
    reduced = reduce_vectors(proj, xd)
    t0 = time.perf_counter()
    opq_payload = get_ops("opq").build(reduced, parse_spec(SPEC_OPQ),
                                       cpu_generator(SEED), BuildInits())
    torch.cuda.synchronize()
    result["opq_index_build_s"] = time.perf_counter() - t0
    eng_opq = SearchEngine.from_state(
        EngineState(corpus=xd, proj=proj, index=Index("opq", opq_payload)),
        config_from_spec(SPEC_OPQ))
    log(f"[path 2] opq index over the same reduced corpus in "
        f"{result['opq_index_build_s']:.1f} s")
    del reduced
    for fn in counters:
        fn.launches = 0
    lat2, found2 = {}, {}
    for name, e in (("pq", eng_pq), ("opq", eng_opq)):
        lat2[name], found2[name] = search_timed(torch, e, qd, BATCHES)
    k2_launches = ops.pq_adc_topk.launches
    result["k2_launches_search"] = k2_launches
    log(f"[path 2] K2 launches in the searches: {k2_launches}")
    check(k2_launches > 0, "K2 never launched on path 2")
    check(ops.pq_adc_gather_topk.launches == 0 and
          ops.pq_adc_cells_topk.launches == 0, "K1 ran on path 2")
    rec2 = {name: {b: recall_at_k(found2[name][b], truth[:b])
                   for b in BATCHES} for name in found2}
    result["path2_latency"] = lat2
    result["path2_recall_at_10"] = rec2
    for name in ("pq", "opq"):
        for b in BATCHES:
            lt = lat2[name][b]
            log(f"[path 2] {name:3s} batch {b:4d}: p50 {lt['p50_ms']:.3f} "
                f"ms p90 {lt['p90_ms']:.3f} ms qps {lt['qps']:.0f} "
                f"recall@10 {rec2[name][b]:.4f}")
        check(rec2[name][256] >= RECALL_FLOOR,
              f"{name} recall@10 {rec2[name][256]} < {RECALL_FLOOR}")
        e = eng_pq if name == "pq" else eng_opq
        je = SearchEngine.from_state(
            e.state, dataclasses.replace(e.config, pq_backend="jnp"))
        _, ij = je.search(qd, K)
        check(torch.equal(ij, found2[name][256]),
              f"{name}: @jnp and @kernel ids differ")
        log(f"[path 2] {name}: @jnp returns the @kernel ids at batch 256")

    # 9. K2 on path 2's own tables and codes; K4's phi on the fit sample
    log("[K2 main]")
    pix = eng_pq.state.index.payload
    qr2 = reduce_vectors(proj, qd)
    t32 = adc_tables(pix.lut_w, pix.cbnorm, qr2)
    tc, _ = center_lut(t32)                  # pq_scan centers bf16 / int8
    for lut, t in (("f32", t32), ("bf16", tc), ("int8", tc)):
        k2_err = max(k2_err, compare_k2(torch, ops, f"K2 main {lut}", t,
                                        pix.codes, RERANK, lut))
    log("[K4 main]")
    gen = cpu_generator(SEED)
    rows = torch.randperm(N, generator=gen)[:FIT_SAMPLE].to(dev)
    sample = xd[rows]
    xs = sample - sample.mean(dim=0)
    rng = np.random.default_rng(4)
    prev = torch.zeros((FIT["m"], DIM), device=dev)
    mask = torch.zeros(FIT["m"], device=dev)
    phi_err = {"value_rel": 0.0, "grad_abs": 0.0}
    for j in range(3):
        w = torch.from_numpy(rng.standard_normal(DIM).astype(np.float32))
        w = (w / w.norm()).to(dev)
        vk, gk = pw.phi_kernel_value_and_grad(w, xs, prev, mask,
                                              b=FIT["b"], alpha=FIT["alpha"])
        vf, gf = fast_objective.phi_fast_value_and_grad(
            w, xs, prev, mask, b=FIT["b"], alpha=FIT["alpha"])
        rel = abs(float(vk) - float(vf)) / abs(float(vf))
        gerr = float((gk - gf).abs().max())
        check(rel <= 1e-5, f"phi value {float(vk)} vs fast {float(vf)}")
        check(torch.allclose(gk, gf, rtol=1e-4, atol=1e-5),
              f"phi gradient differs from fast (max {gerr})")
        phi_err = {"value_rel": max(phi_err["value_rel"], rel),
                   "grad_abs": max(phi_err["grad_abs"], gerr)}
        prev[j] = w                          # later draws pay the penalty
        mask[j] = 1.0
    result["phi_kernel_vs_fast"] = phi_err
    log(f"[K4 main] phi kernel vs fast on the fit sample: {phi_err}")

    # 10. timings: K2 at every batch, K4 at the fit's N, path 2's searches
    m2, kc2 = pix.cbnorm.shape
    k2_runs = k2_timings(torch, ops, {"f32": t32, "bf16": tc, "int8": tc},
                         pix.codes)
    k2_main = k2_runs["int8 Q=256"]
    k2_ms, k2_bound, k2_by, k2_plain_ms = (
        k2_main["ms"], k2_main["bound_ms"], k2_main["bound_by"],
        k2_main["plain_ms"])
    log(f"[timings] K2 {k2_ms:.4f} ms ({k2_main['device_ms']:.4f} ms of "
        f"its kernels), plain {k2_plain_ms:.4f} ms, bound {k2_bound:.4f} ms "
        f"({k2_by}) at Q=256 N={N} M={m2} K={kc2} k={RERANK} int8; no "
        "single PyTorch call computes K2, so no library time")
    k_pairs = num_selected_pairs(FIT_SAMPLE, FIT["b"])
    p = xs @ w
    k4_err = max(k4_err, compare_k4_fused(torch, pw, fast_objective,
                                          "K4 fused main", p, k_pairs))
    # the fused step against the two-step route (the bisection, then K4 at
    # tau):
    # a fit of FIT_CHECK_M directions from the same start, directions bit
    # for bit (tau, the count and coeff are exact; only phi's sum rounds
    # otherwise)
    w0 = torch.from_numpy(rng.standard_normal((FIT_CHECK_M, DIM)).astype(
        np.float32)).to(dev)

    def phi_at_tau(w, x, prev, mask, *, b, alpha):
        k = num_selected_pairs(x.shape[0], b)
        wn = w / torch.linalg.vector_norm(w)
        pp = x @ wn
        tau = fast_objective.find_quantile_threshold(pp, k)
        cnt, sm, coeff = pw.pairwise_stats(pp, tau)
        cntf = cnt.clamp_min(1).to(pp.dtype)
        value = (sm - (cntf - k) * tau) / k
        g_raw = (x.T @ coeff) / cntf
        return objective.penalized(value, g_raw - torch.dot(g_raw, wn) * wn,
                                   w, prev, mask, alpha)

    fits = {}
    for name, phi_vg in (("fused", pw.phi_kernel_value_and_grad),
                         ("at_tau", phi_at_tau)):
        fits[name] = fit_run(torch, mpad_mod, phi_vg, xs, w0,
                             m=FIT_CHECK_M)
    check(torch.equal(fits["fused"][0], fits["at_tau"][0]),
          "the fused fit's directions differ from the two-step route's")
    trace_rel = float(((fits["fused"][1] - fits["at_tau"][1]).abs()
                       / fits["at_tau"][1].abs()).max())
    result["k4_fit_check"] = {
        "m": FIT_CHECK_M, "iters": FIT["iters"], "directions_bit_equal": True,
        "phi_trace_max_rel_diff": trace_rel,
        "fused_s": fits["fused"][2], "at_tau_s": fits["at_tau"][2]}
    log(f"[K4 main] a fit of {FIT_CHECK_M} x {FIT['iters']} steps: fused "
        f"{fits['fused'][2]:.3f} s, the two-step route "
        f"{fits['at_tau'][2]:.3f} s; directions bit for bit, phi traces "
        f"within {trace_rel:.2e} relative")
    k4t = k4_time(torch, pw, fast_objective, p, k_pairs)
    k4t["launches_per_step"] = {
        "fused": step_launches(torch, mpad_mod, pw.phi_kernel_value_and_grad,
                               xs, w0),
        "at_tau": step_launches(torch, mpad_mod, phi_at_tau, xs, w0)}
    k4t["fit_s"] = eng_pq.build_seconds["fit"]
    log_k4_time("timings", k4t)
    log(f"[timings] kernel launches a fit step: "
        f"{k4t['launches_per_step']}; path 2's fit "
        f"({FIT['m'] * FIT['iters']} steps) {k4t['fit_s']:.3f} s; no single "
        "PyTorch call computes K4, so no library time")
    k4_ms, k4_plain_ms = k4t["fused_device_ms"], k4t["fused_plain_ms"]
    k4_bound = k4t["fused_bound_ms"]
    k4_by = k4t["fused_bound_by"]
    result["k2_timing"] = {"ms": k2_ms, "plain_ms": k2_plain_ms,
                           "bound_ms": k2_bound, "runs": k2_runs}
    result["k4_timing"] = k4t
    log(f"[timings] path 2 pq build stages (s): "
        f"{ {k: round(v, 3) for k, v in eng_pq.build_seconds.items()} }")

    def host_ms(fn, reps=50):
        """Host time of ``fn()``, synchronized, in ms a call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def step(phi_vg):
        return lambda: phi_vg(w, xs, prev, mask, b=FIT["b"],
                              alpha=FIT["alpha"])

    # one fit step's objective on each backend, and its shared threshold
    # bisection alone
    steps = {"fast": host_ms(step(fast_objective.phi_fast_value_and_grad)),
             "kernel": host_ms(step(pw.phi_kernel_value_and_grad)),
             "threshold": host_ms(
                 lambda: fast_objective.find_quantile_threshold(p, k_pairs))}
    result["phi_step_ms"] = steps
    log(f"[timings] one fit step's objective, host ms: "
        f"{ {k: round(v, 3) for k, v in steps.items()} }")
    result["path2_device_busy"] = {
        b: device_busy(torch, eng_pq, qd[:b], f"pq batch {b}")
        for b in (1, 256)}

    # F3: int32 codes (K 1024) through K2
    result["pq1024"] = pq1024_path(
        torch, (ops, knn, build_engine, SearchEngine, recall_at_k), xd, qd,
        counters)

    # 20-24. path 5: the evaluation path on K3, before path 3 frees the
    # search tensors
    path5, k3_launches, k3_main_err, k3 = eval_path(
        torch, (knn_topk, knn, MPADConfig, fit_mpad, fast_objective,
                objective, mpad_mod, baselines, paper, cpu_generator,
                build_engine, reduce_vectors, exact_rerank, recall_at_k, ops,
                SearchEngine),
        xd, counters)
    result["path5"] = path5
    k3_err = max(k3_err, k3_main_err)

    # path 6: path 1's engine made streaming, the write leg on K1's
    # masked cell-major scan; then the ivf kind and the pre-filter
    path6, k1_path6, k1_p6_err = stream_path(
        torch, (ops, ref, ivfpq, knn, SearchEngine, StreamConfig, segments,
                recall_at_k, adc_tables, probe_cells, reduce_vectors,
                tree_map), eng, xd, qd, counters)
    result["path6"] = path6
    max_err = max(max_err, k1_p6_err)
    result["ivf"] = ivf_phase(torch, (build_engine, recall_at_k), xd, qd,
                              truth, counters)
    result["prefilter"] = prefilter_phase(
        torch, (build_engine, SearchEngine), xd, qd)

    # 28. path 7: snapshots, the WAL, crash recovery and a follower on
    # path 1's state, before path 3 frees the search tensors
    torch.cuda.empty_cache()
    result["path7"], k1_path7 = persist_path(
        torch, (ops, knn, SearchEngine, StreamConfig, segments, recall_at_k,
                load_engine, durability, recovery, wal_mod), eng, xd, qd,
        result["engine_build_s"])

    # 29. path 8: observability on path 1's engine, before path 3 frees
    # the search tensors
    torch.cuda.empty_cache()
    result["path8"], k1_path8, k3_path8 = observe_path(
        torch, (ops, knn_topk, knn, SearchEngine, StreamConfig, segments,
                recall_at_k, tracing, MetricsServer, render_prometheus),
        eng, xd, qd)

    # 30. path 9: sharded serving on the one card, before path 3 frees the
    # search tensors
    torch.cuda.empty_cache()
    result["path9"], launches9 = shard_path(
        torch, (ops, knn_topk, SearchEngine, build_engine, StreamConfig,
                MPADConfig, fit_mpad, fit_mpad_sharded, make_serving_mesh,
                run_ranks, cpu_generator, fast_objective, make_phi_dist),
        eng, eng_pq, (tc, pix.codes), xd, qd, counters, smi)
    k2_err = max(k2_err, result["path9"]["k2_global_check"]["max_abs_err"])

    # 11-14. path 3: the LM serving path on K5
    lm, k5_launches, k5_main_err, k5 = lm_path(
        torch, tf, fa, lm_param_count, rms_norm, TINYLLAMA, counters)
    result["path3"] = lm
    result["k5_timing"] = k5
    k5_err = max(k5_err, k5_main_err)

    # 15-19. path 4: the LM training path on K5 (forward + Function) and K6
    del eng, jeng, eng_pq, eng_opq, je, e, state, ix, pix, xd, sample, xs
    torch.cuda.empty_cache()
    train, k6_launches, k5_train_launches, k6_main_err, k6, k5_fn_err = \
        train_path(torch, (tf, fa, fce, optim, data, runtime, lm_param_count),
                   TINYLLAMA, TINY_SMOKE, counters)
    result["path4"] = train
    result["path4"]["k5_function_max_rel_err"] = k5_fn_err
    result["k6_timing"] = k6
    k6_err = max(k6_err, k6_main_err)

    # 31. path 10: the MoE LMs served on K5, path 4's tensors freed first
    torch.cuda.empty_cache()
    result["path10"], k5_path10, k5_moe_err = moe_path(
        torch, (tf, fa, moe, lm_param_count, shape_config, rms_norm,
                chunked_attention), (GRANITE_MOE, OLMOE), counters)
    k5_err = max(k5_err, k5_moe_err)

    # 32. path 11: the recsys family; the two-tower reducer fitted on K4
    result["path11"], k4_path11 = recsys_path(
        torch, (rs, recsys_family, (sasrec.CONFIG, dien.CONFIG,
                                    autoint.CONFIG, two_tower_retrieval),
                data.recsys_ranking_batch, MPADConfig, fit_mpad, pw,
                cpu_generator), counters)
    check(k4_path11 > 0, "K4 never launched on path 11")

    # 33. path 12: gin-tu at the four GNN_SHAPES, full graphs on the
    # aggregate
    result["path12"], agg_launches, agg_t = gnn_path(
        torch, (gnn, ga, gnn_family, optim, tree_map, gin_tu.CONFIG),
        gnn_graph_in, counters)
    result["path12"]["host_generation_s"] = gen_s
    result["path12"]["host_generation_wait_s"] = gen_wait_s

    # 34. path 13: granite-moe-1b-a400m trained on K5 and K6, then the
    # recsys family at train_batch
    snap13 = {}
    p13, k5_path13, k6_path13, k6_p13_err = moe_train_path(
        torch, (tf, fa, fce, optim, data, lm_param_count), GRANITE_MOE,
        counters, snap=snap13)
    k6_err = max(k6_err, k6_p13_err)

    # 35. path 14 (a): the sharded step on a (1, 1) mesh over NCCL against
    # path 13's first steps
    p14a, k5_path14, k6_path14 = shard_train_a(
        torch, (tf, fa, fce, optim, data, psh, pstep, make_mesh),
        GRANITE_MOE, snap13, counters)
    del snap13
    result["path13"] = {GRANITE_MOE.name: p13, "recsys": recsys_train_path(
        torch, (rs, recsys_family, (sasrec.CONFIG, dien.CONFIG,
                                    autoint.CONFIG, two_tower_retrieval.CONFIG),
                data, optim, tree_map, cpu_generator), counters)}

    # 35. path 14 (b): SHARD_MESH gloo ranks on the card
    p14b, (k5_ranks14, k6_ranks14) = shard_train_b(
        torch, (tf, fa, fce, optim, data, moe, rms_norm, chunked_attention),
        GRANITE_MOE, run_ranks, smi)
    result["path14"] = {"a": p14a, "b": p14b}

    # 36. path 15: the dry-run, against path 14 and real steps
    # (path 16 (b)'s gloo ranks run beside its trace jobs)
    p15, launches15, serve_dry, p16b = dryrun_path(
        torch, (psh, analyze_step, phi_step, phi_args, make_mesh,
                optim.init_opt_state), p14a, p14b, counters,
        beside=lambda: serve_b(torch, tf, shape_config, run_ranks, smi))
    result["path15"] = p15

    # 37. path 16: LM prefill and decode over a ("data", "model") mesh
    p16, k5_path16, k5_ranks16, k5_p16_err, k5_16 = serve_path(
        torch, (tf, fa, psh, pstep, make_mesh, shape_config, lm_param_count,
                tensor_bytes, rms_norm), (TINYLLAMA, GEMMA3), counters, smi,
        p16b, serve_dry)
    result["path16"] = p16
    k5_err = max(k5_err, k5_p16_err)

    k1b = k1t["bounds"]
    k1_src = "src/repro_torch/kernels/pq_adc/csrc/pq_adc_gather_topk.cu"
    k4_src = "src/repro_torch/kernels/mpad_pairwise/csrc/pairwise_stats.cu"
    k1_cells = {
        "name": "pq_adc_cells_topk", "launches": result["k1_launches"]["cells"],
        "ms": k1t["cells_ms"], "device_ms": k1t["cells_device_ms"],
        "plain_ms": k1t["cells_plain_ms"],
        "bound_ms": k1b["cells"]["bound_ms"],
        "bound_by": k1b["cells"]["bound_by"],
        "l2_ms": k1b["cells"]["l2_ms"], "library_ms": None}
    k1_gathered = {
        "name": "pq_adc_gather_topk",
        "launches": result["k1_launches"]["gathered"],
        "ms": k1t["gathered_ms"], "device_ms": k1t["gathered_device_ms"],
        "plain_ms": k1t["gathered_plain_ms"],
        "bound_ms": k1b["gathered"]["bound_ms"],
        "bound_by": k1b["gathered"]["bound_by"], "library_ms": None}
    k4_at_tau = {
        "name": "pairwise_stats", "launches": k4_unfused_launches,
        "ms": k4t["unfused_device_ms"], "plain_ms": k4t["unfused_plain_ms"],
        "bound_ms": k4t["unfused_bound_ms"], "bound_by": "operations",
        "library_ms": None}
    p6t = path6["k1_timing"]
    k1_live = {
        "name": "pq_adc_cells_topk (fills + cell-major live map)",
        "launches": k1_path6, "ms": p6t["live_ms"],
        "device_ms": p6t["live_device_ms"],
        "plain_ms": p6t["live_plain_ms"], "bound_ms": p6t["bound_ms"],
        "bound_by": p6t["bound_by"], "library_ms": None,
        "cand_route_device_ms": p6t["cand_device_ms"],
        "fills_alone_device_ms": p6t["cell_len_device_ms"],
        "map_build_ms": p6t["map_build_ms"],
        "cand_mask_ms": p6t["cand_mask_ms"]}
    kernels = [dict(k1_cells, **{
        "name": "pq_adc_gather_topk", "route": "cuda", "source": k1_src,
        "replaces": "src/repro/kernels/pq_adc/kernel.py:212",
        "launches": launches, "max_abs_err": max_err,
        "launches_path6": k1_path6, "launches_path7": k1_path7,
        "launches_path8": k1_path8, "launches_path9": launches9["k1_cells"],
        "entries": [k1_cells, k1_gathered, k1_live],
        "note": "two entries of one kernel: the cell-major entry (the "
                "padded scan at batch 256; its times are the kernel's "
                "here, at path 1's batch-256 scan, int8) and the gathered "
                "entry (the compact scan at batches 1/8/64); launches: "
                "both, path 1's main run; launches_path6: the cell-major "
                "entry on the fills with the cell-major live map "
                "(tombstones) in "
                "path 6's write leg, timed at its batch-256 scan; "
                "launches_path7: the cell-major entry in path 7's searches "
                "of the restored and the recovered engines; "
                "launches_path8: the cell-major entry in path 8 (the "
                "traced and untraced searches, the deep traces' scan "
                "stage, the streaming search, the profiled and timed "
                "searches); launches_path9: the cell-major entry on path "
                "9's sharded route (world 1, NCCL), probes of cells owned "
                "elsewhere passed as -1"}), {
        "name": "pq_adc_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/pq_adc/csrc/pq_adc_topk.cu",
        "replaces": "src/repro/kernels/pq_adc/kernel.py:120",
        "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None, "launches_path9": launches9["k2_global"],
        "note": "ms: one call at Q 256 int8 on path 2's tables; "
                "result.k2_timing.runs has int8 at batches 1/8/64/256 and "
                "f32/bf16 at 256, each with its kernels' device time and "
                "the plan (queries a block, occupancy, waves); "
                "launches_path9: through pq_adc_topk_global on path 9's "
                "sharded pq route (world 1, NCCL)"}, {
        "name": "pairwise_stats", "route": "cuda", "source": k4_src,
        "replaces": "src/repro/kernels/mpad_pairwise/kernel.py:64",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
        "library_ms": None,
        "entries": [{"name": "pairwise_stats_at_quantile",
                     "launches": k4_launches, "ms": k4_ms,
                     "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
                     "bound_by": k4_by, "library_ms": None,
                     "floor_ms": k4t["floor_device_ms"]}, k4_at_tau],
        "launches_path11": k4_path11,
        "note": "two entries of one kernel: the fused threshold search and "
                "statistics (one launch a fit step, path 2's fit; its "
                "times are the kernel's here, device time at N 2048) and "
                "the statistics at a given tau (off the main path: "
                "its edge cases and timings); launches_path11: the fused "
                "entry in path 11's two-tower reducer fit (m 64, N 2048)"},
        {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": k5_launches, "max_abs_err": k5_err, "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
        "note": "forward + autograd.Function; bf16 on the tensor cores "
                "(mma.sync), f32 inputs on flash_attention_fwd.cu (the "
                "edge cases); launches: path 3's prefill and decode; "
                "launches_path4: path 4's training steps; "
                "launches_path10: path 10's MoE prefills and decodes "
                "(granite-moe-1b-a400m and olmoe-1b-7b; their K5 times "
                "are in result.path10.<config>.k5_timing); "
                "launches_path13: granite-moe-1b-a400m's training steps "
                "on path 13 (K5 at its shape, with the Function's "
                "backward a layer, in result.path13.<config>.k5_timing); "
                "launches_path14: path 14 (a)'s two sharded steps on a "
                "(1, 1) NCCL mesh; launches_path14_ranks: each of path 14 "
                "(b)'s 4 gloo ranks over its two steps, all bf16; "
                "launches_path15: path 15 (c)'s real SMOKE-size step (f32 "
                "route), whose fake trace counts the same; the launch is "
                "a torch.library custom op since PR 26; launches_path16: "
                "path 16 (a)'s rank programs on a (1, 1) NCCL mesh (the "
                "2 x 32768 prefill and the decode cache's 8 x 32752 fill, "
                "bf16); launches_path16_ranks: each of path 16 (b)'s 4 "
                "gloo ranks' prefill by case; entries: K5 at path 16 (a)'s "
                "prefill shape (B 2, S 32768, TinyLlama's heads)",
        "launches_path4": k5_train_launches,
        "launches_path10": k5_path10, "launches_path13": k5_path13,
        "launches_path14": k5_path14,
        "launches_path14_ranks": k5_ranks14,
        "launches_path15": launches15["flash_attention_fwd"],
        "launches_path16": k5_path16, "launches_path16_ranks": k5_ranks16,
        "entries": [{
            "name": "flash_attention_fwd (B 2, S 32768)", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bf16.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
            "launches": k5_path16, "max_abs_err": k5_p16_err,
            "ms": k5_16["ms"], "plain_ms": k5_16["plain_ms"],
            "bound_ms": k5_16["bound_ms"], "bound_by": k5_16["bound_by"],
            "library_ms": k5_16["library_ms"]}]}, {
        "name": "fused_ce_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_ce/csrc/fused_ce_bf16.cu",
        "replaces": "src/repro/kernels/fused_ce/kernel.py:64",
        "launches": k6_launches, "max_abs_err": k6_err, "ms": k6["ms"],
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"], "library_ms": None,
        "note": "bf16 on the tensor cores (mma.sync), every launch of path "
                "4 on it; f32 and mixed inputs on fused_ce_fwd.cu (the "
                "edge cases; result.k6_timing.f32_route_ms at path 4's "
                "shape); launches_path13: granite-moe-1b-a400m's training "
                "steps on path 13, tied head embed.T (its time at T 4096, "
                "D 1024, V 49408 in result.path13.<config>.k6_timing); "
                "launches_path14: path 14 (a)'s two sharded steps; "
                "launches_path14_ranks: each of path 14 (b)'s 4 gloo ranks "
                "over its two steps (the tied head, bf16); "
                "launches_path15: path 15 (c)'s real SMOKE-size step (f32 "
                "route); the launch is a torch.library custom op",
        "launches_path13": k6_path13, "launches_path14": k6_path14,
        "launches_path14_ranks": k6_ranks14,
        "launches_path15": launches15["fused_ce_fwd"]}, {
        "name": "knn_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
        "replaces": "src/repro/kernels/knn_topk/kernel.py:72",
        "launches": k3_launches, "max_abs_err": k3_err, "ms": k3["ms"],
        "launches_path8": k3_path8, "launches_path9": launches9["k3"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        "note": "times at the flat engine's scan (Q 256, N 1M, D 64, k 64; "
                "result.path5.k3_timings has the truth, reduced and "
                "transform shapes); launches: path 5's 35 amk_accuracy "
                "calls; launches_path8: path 8's shadow recall checks; "
                "launches_path9: the flat engine's shard-local scans on "
                "path 9 (world 1, NCCL); "
                "library_ms: the two-call yardstick topk(cdist(q, "
                "x), k, largest=False), which the port never calls"}, {
        "name": "csr_gather_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/graph_agg/csrc/csr_gather_sum.cu",
        "replaces": "src/repro/models/gnn.py:81 (jax.ops.segment_sum: no "
                    "pallas_call; a port-only kernel)",
        "launches": agg_launches, "max_abs_err": agg_err,
        "ms": agg_t["fwd_f64"]["ms"], "plain_ms": agg_t["fwd_f64"]["plain_ms"],
        "bound_ms": agg_t["fwd_f64"]["bound_ms"], "bound_by": "bytes",
        "library_ms": agg_t["fwd_f64"]["library_ms"],
        "gathered_bound_ms": agg_t["fwd_f64"]["gathered_bound_ms"],
        "note": "GIN's neighbour sum in edge order (no atomics), forward on "
                "the destination order, backward on the source order; "
                "times at ogb_products' layers 1-4 forward (N 2,449,029, E "
                "61,859,328, F 64; result.path12.ogb_products."
                "aggregate_timing has F 100 and the backward); bound_ms "
                "reads each input once, gathered_bound_ms an x row for "
                "every edge; library_ms: torch.sparse.mm of the CSR by h, "
                "which the port never calls; launches: path 12's main "
                "runs (full_graph_sm and ogb_products, 5 forward and 4 "
                "backward a step); launches_path15: path 15 (c)'s real "
                "SMOKE-size GIN step (3 forward, 2 backward)",
        "launches_path15": launches15["csr_gather_sum"]}]
    result["trace_losses"] = TRACE_LOSSES
    log(f"[trace] {len(TRACE_LOSSES)} traces lacked records, "
        f"{sum(r['used'] for r in TRACE_LOSSES)} of them used")
    result["wall_s"] = time.perf_counter() - wall0
    log(f"[done] wall time {result['wall_s']:.1f} s")
    print(json.dumps({"result": result}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def spread_rank(mesh, sample, w0):
    """One gloo rank of ``--fit-spread``: the sharded fit at path 2's m 64
    / iters 48."""
    import torch
    from repro_torch.core import MPADConfig
    from repro_torch.core.distributed import fit_mpad_sharded
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = fit_mpad_sharded(torch.from_numpy(sample), MPADConfig(**FIT), mesh,
                           w0=torch.from_numpy(w0))
    torch.cuda.synchronize()
    return res.matrix.cpu().numpy(), time.perf_counter() - t0


def fit_spread():
    """``python3 chip_smoke.py --fit-spread``: path 9 (c)'s m-64 fits, made
    once, on path 1's 2048-row fit sample with path 9's start directions
    (path 2's m 64 / iters 48, the fast objective): ``fit_mpad`` on the
    rows in their order, on ``SPREAD_PERMS`` permutations of them, and
    ``fit_mpad_sharded`` at world 2 (gloo ranks on cuda:0, beside the
    other fits). Each matrix's max |d| from the first: the world-2 fit's
    distance read against the spread of the permuted-row fits (the same
    sums in another order, as two ranks' partial sums are; the greedy
    Adam fit amplifies such a change). Prints the card's line and one
    JSON line {"fit_spread": {...}}; exits nonzero without a card."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch._device import cpu_generator
    from repro_torch.core import MPADConfig, fit_mpad
    from repro_torch.launch.mesh import run_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_line()
    dev = torch.device("cuda")
    xd = torch.from_numpy(clustered_corpus(N, DIM, SEED)).to(dev)
    rows = torch.randperm(N, generator=cpu_generator(SEED))[:FIT_SAMPLE]
    sample = xd[rows.to(dev)].cpu().numpy()
    del xd
    w0 = np.random.default_rng(SEED + 9).standard_normal(
        (FIT["m"], DIM)).astype(np.float32)
    box = {}

    def world2():
        try:
            box["world2"] = run_ranks(spread_rank, 2, (sample, w0),
                                      backend="gloo", device="cuda:0",
                                      timeout=900)
        except BaseException as exc:        # re-raised below
            box["error"] = exc

    worker = threading.Thread(target=world2, name="spread-world2")
    worker.start()
    mats, secs = {}, {}
    try:
        orders = [("rows in order", np.arange(FIT_SAMPLE))] + [
            (f"rows permuted, seed {SEED + 90 + i}",
             np.random.default_rng(SEED + 90 + i).permutation(FIT_SAMPLE))
            for i in range(SPREAD_PERMS)]
        for name, perm in orders:
            t0 = time.perf_counter()
            res = fit_mpad(torch.from_numpy(sample[perm]), MPADConfig(**FIT),
                           w0=torch.from_numpy(w0), device=dev)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            mats[name] = res.matrix.cpu().numpy()
    finally:
        worker.join()
    if "error" in box:
        raise box["error"]
    mats["world 2"], secs["world 2"] = box["world2"]
    ref = mats["rows in order"]
    dist = {k: float(np.abs(v - ref).max()) for k, v in mats.items()
            if k != "rows in order"}
    perm_d = [v for k, v in dist.items() if k.startswith("rows permuted")]
    r = {"rows": FIT_SAMPLE, "config": FIT, "matrix_max_abs_diff": dist,
         "permuted_min": min(perm_d), "permuted_max": max(perm_d),
         "s": secs, "card": smi}
    log(f"[fit spread] m {FIT['m']} iters {FIT['iters']} on {FIT_SAMPLE} "
        f"rows, max |d| from fit_mpad on the rows in order: "
        + "; ".join(f"{k} {v:.4f}" for k, v in dist.items()) + f" ({smi})")
    print(json.dumps({"fit_spread": r}))
    return 0


def custom_op_timings():
    """``--custom-op-timings``: K5 (bf16, path 3's shape), K6 (bf16, path
    4's) and the GIN aggregate (forward at F 64 and 100, backward at F 64,
    on a uniform random graph of ogb_products' size) alone on seeded
    inputs, by CUDA events, through the package beside this script: a copy
    of the script at the root of another commit's ``git archive`` times
    that commit's launches in the same call (their custom-op binding
    against the parent's direct calls). One JSON line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as fce
    from repro_torch.kernels import graph_agg as ga
    smi = card_line()
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    out = {"card": smi, "tree": HERE}
    q, k, v = (randn(4, 4096, h, 64).bfloat16() for h in (32, 4, 4))
    out["k5_ms"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v),
                           reps=20)
    del q, k, v
    h = randn(4096, 2048).bfloat16()
    w = (randn(2048, 32000) * 0.02).bfloat16()
    lab = torch.randint(0, 32000, (4096,), generator=g, device="cuda")
    out["k6_ms"] = cuda_ms(torch, lambda: fce.fused_ce_fwd(h, w, lab),
                           reps=20)
    del h, w
    n, e = 2_449_029, 61_859_328
    csr = ga.build_csr(*(torch.randint(0, n, (e,), generator=g,
                                       device="cuda") for _ in range(2)),
                       None, n)
    for f in (64, 100):
        x = randn(n, f)
        out[f"agg_fwd_f{f}_ms"] = cuda_ms(
            torch, lambda: ga.csr_gather_sum(x, csr.fwd), reps=10)
        if f == 64:
            out["agg_bwd_f64_ms"] = cuda_ms(
                torch, lambda: ga.csr_gather_sum(x, csr.bwd), reps=10)
        del x
    print(json.dumps({"custom_op_timings": out}))
    return 0


ALONE = {"--k1-timings": k1_alone, "--k2-timings": k2_alone,
         "--k4-timings": k4_alone, "--fit-spread": fit_spread,
         "--dryrun-smoke": dryrun_smoke, "--dryrun-serve": dryrun_serve,
         "--custom-op-timings": custom_op_timings}

if __name__ == "__main__":
    ARGS = sys.argv[1:]
    if ARGS and (len(ARGS) > 1 or ARGS[0] not in ALONE):
        sys.exit(f"usage: {sys.argv[0]} [{' | '.join(ALONE)}]")
    sys.exit(ALONE[ARGS[0]]() if ARGS else main())
