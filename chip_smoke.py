#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and the CUDA toolkit
(``nvcc`` on PATH or under ``/usr/local/cuda``).  Exits non-zero, and
prints no result, without a card or outside a checkout of the repo.
Every phase prints one JSON line; any failing phase raises and ends the
run.  Phases:

1. device   — name, capability, ``nvidia-smi`` name and power limit;
2. build    — the kernels, built from ``csrc/`` with ``nvcc`` (one
   process per source, all at once) into ``build/kernels/``; for the four
   flash kernels (fp32 ``flash_fwd_3xtf32`` / ``flash_bwd_3xtf32``, bf16
   ``flash_fwd_tc`` / ``flash_bwd_tc``), their registers, spills and
   shared memory per instantiation, and the tensor-core instructions
   (``HGMMA``, ``HMMA``) and TMA loads in their SASS; for the scan's
   ``ssm_scan`` and ``ssm_scan_bwd``, their registers, spills and static
   shared memory per instantiation and the backward's dynamic shared
   memory at the checkpoint spacing the autograd function uses;
3. kernels  — each kernel against its plain PyTorch version on the card
   (commit_grid: ragged and sentinel-clamp cases in fp32 and bf16, and
   the main path's shape with the row counts of the train run below);
4. train    — the port's ``launch.train.main`` at full width rfast-100m
   (4 nodes, binary tree, uniform scenario, 4 steps: K = 16 events),
   with the launch counters zeroed just before it and read just after;
5. backends — ``impl="kernel"`` vs ``impl="plain"`` on the card at two
   layers (full width and vocab), same seed and schedule;
6. timing   — each kernel and its plain version at the main path's
   shape, median of CUDA-event times, beside the bandwidth bound;
7. flash kernels — each flash kernel against its plain twin on the card
   at small odd cases (D 32/48/64/128, GQA 1/4/5, causal / full / window,
   Sq != Sk, ragged S): in fp32 ``flash_fwd_3xtf32`` and the fused
   ``flash_bwd_3xtf32`` (3xTF32 on the tensor cores), in bf16
   ``flash_fwd_tc`` and the fused ``flash_bwd_tc`` (dO in bf16), at
   those cases and at head dims the wrappers pad: D % 4 != 0 (35) in
   both, D % 8 != 0 (36) and D % 16 != 0 (40) in bf16;
8. flash path — the flash attention op and its autograd function at full
   attention width (llama3-8b, hymba-1.5b, rfast-100m; fp32 and bf16
   each), forward and forward+backward, against the plain twins, with
   the launch counters zeroed just before and read after (fp32: 1
   ``flash_fwd_3xtf32``, then 1 each of ``flash_fwd_3xtf32`` and
   ``flash_bwd_3xtf32``; bf16: the same of ``flash_fwd_tc`` and
   ``flash_bwd_tc``);
9. flash timing — each flash kernel, its plain twin and PyTorch's
   ``scaled_dot_product_attention`` at the llama3-8b and hymba-1.5b
   shapes, in fp32 and bf16 (both sides read a dO of the inputs' dtype),
   beside the bound (fp32: operations at the 3xTF32 rate, with the
   CUDA-core bound beside it).  The library call is timed forward and
   backward through autograd, with its backend and its errors against
   the plain twins: in bf16 the backend PyTorch picks with GQA; in fp32
   also the efficient backend forced on k, v repeated to H heads (the
   repeat outside the timed window), the faster call within the fp32
   tolerance being the yardstick;
10. node kernels — ``rfast_update_node`` and ``rfast_commit_node``
   against their plain twins (P 1, 37, 4097, 100,001 in fp32 and bf16,
   slot counts (Kw, Ka, Ko) (1, 2, 1) and (2, 3, 2), random weights and
   0/1 masks), then the ops ``rfast_update(outputs="full")`` and
   ``rfast_commit(oracle=True)`` at full width (P = p of rfast-100m,
   fp32) with the launch counters zeroed just before and read after;
11. sync train — ``launch.train.main`` with no ``--scenario`` at full
   width rfast-100m (4 nodes, binary tree, ``--impl kernel``), 3 rounds
   with no loss, then 3 rounds with ``--loss-prob 0.2 --momentum 0.9``,
   the counters zeroed before each and read after, and the allocator
   read before each call, after its init and after its first round;
12. round routes — the protocol round's ``kernel``, ``kernel`` with
   ``oracle=True`` and ``plain`` routes from one state at two layers of
   full width, 4 lossy rounds each, with their launches;
13. node timing — each node kernel and its plain twin at full width,
   and ``commit_grid`` at the round's shape (B = 4 nodes; its bound
   counts the rows the round keeps, not the pad slots it drops), median
   of CUDA-event times, beside the bandwidth bound;
14. scan kernels — ``ssm_scan`` against its plain twin ``ssm_scan_plain``
   (y, h_last and the checkpoints at the autograd function's spacing;
   1e-4 fp32, 3e-2 bf16), unsplit and with its time axis split in 3, and
   ``ssm_scan_bwd`` against ``ssm_scan_bwd_plain`` (the six gradients,
   with and without a gradient of h_last, within the same tolerances
   relative to each gradient's largest entry) at tests/test_kernels.py's
   scan cases, at ragged di (200, 3200), S (1, 100, 129) and N (4, 16),
   and at hymba-1.5b's train shape (B 4, S 128, di 3200, N 16), with dt
   drawn as the model feeds it and B, C as column slices of one
   projection; then ``SelectiveScanFn``'s gradients (both kernels)
   against plain autograd of the ref at that shape (1e-4 relative);
15. hymba sync train — ``launch.train``'s synchronous regime on full-width
   hymba-1.5b cut to 2 of its 32 layers (4 nodes, binary tree,
   ``--impl kernel``): 3 rounds, then 3 rounds with ``--loss-prob 0.2
   --momentum 0.9``; the counters zeroed before each and read after
   (``ssm_scan`` = ``ssm_scan_bwd`` = layers × gradients, ``commit_grid``
   = rounds), the allocator read before each call, after its init and
   after round 1;
16. scan timing — at hymba-1.5b's train shape and at the op widths of
   hymba-1.5b (S 4096, di 3200) and falcon-mamba-7b (S 4096, di 8192):
   the forward (without checkpoints, as before; with them, as the
   autograd function runs it; at the op widths unsplit and at the split
   ``scan_segments`` chooses), the backward kernel, and their plain twins
   (the backward's at the op widths once), median of CUDA-event times,
   beside the bounds (bytes at 3.35 TB/s; fp32 operations; exponentials
   at the MUFU rate of 16 per clock per SM at the card's maximum SM
   clock; the backward's with its checkpoints every
   ``SCAN_BOUND_CKPT_EVERY`` steps, and beside it at the kernel's
   ``CKPT_EVERY``); a kernel timed as 20 launches in a CUDA graph per
   event pair (and the forward as one call, host work included, as
   ``call_ms``), and ``SelectiveScanFn`` forward + backward (both
   kernels, through autograd) as one SSM layer's gradient pays it.

17. event oracle — the port's ``run_rfast(mode="event")`` (snapshot
   histories, no kernel) and ``run_rfast(mode="wavefront",
   impl="kernel")`` at full-width rfast-100m on phase 4's schedule (4
   nodes, binary tree, uniform, K = 16, batch 4 × 128), one after the
   other, the first's x, v, z, g_prev, ρ and ρ̃ kept: both engines draw
   the same gradients, so every field agrees to 1e-4 of its largest
   entry; the event run launches no ``commit_grid``, the wavefront run
   one per wave;
18. fleet sweep — (a) ``run_sweep`` over 8 lanes (``straggler`` and
   ``packet_loss`` × seeds 0–3) of the paper's logistic regression
   (``make_logistic_problem`` at its defaults, label-sorted shards, 7
   nodes on a binary tree, K = 7000, eval every 1000): one
   ``commit_grid`` launch per fleet wave (fewer than the lanes' waves
   summed), every lane equal to ``run_rfast`` of its schedule and seed
   to 1e-5, each lane's loss, accuracy and time to the loss target;
   the fleet's widest wave's ``commit_grid`` (Pf = 785) held to its
   plain twin and timed; and a short fleet (``TRACE_K`` events a lane)
   run under ``torch.profiler`` for the card's busy share of its span;
   (b) two lanes at rfast-100m's width cut to 2 layers (uniform, seeds 0
   and 1, K = 16), held the same way, and one fleet wave's
   ``commit_grid`` (its widest) timed beside its bytes bound;
19. baselines — the six runners of ``core/baselines.py`` on phase 18's
   logistic problem under the straggler scenario (300 rounds, or 2100
   events), each with its final loss, accuracy, first virtual time at
   the loss target and wall seconds, beside the R-FAST straggler lanes
   of phase 18; each runner's card run held to its CPU run at a small
   key-free size (batch 0, 20 rounds or 140 events) to 1e-5.

20. dynamic membership — (a) ``launch.train.main`` on ``churn`` at
   full-width, full-depth rfast-100m (binary tree, 4 nodes, 20 steps: K
   80 in 3 membership epochs), its ``commit_grid`` launches equal to the
   epochs' non-empty waves as the port's planner counts them on the
   host, the Lemma-3 residual of the final state ≤ 1e-4; (b)
   ``run_epochs`` on ``root_failover`` (robust tree, 4 nodes, K 160: the
   sole root departs and 1 is re-elected) at full width cut to 2 layers,
   ``impl="kernel"`` then ``"plain"``, every field within 1e-5 of its
   largest entry, and the widest epoch wave's ``commit_grid`` held to
   its twin and timed beside ``commit_grid_bytes``' bound; (c)
   tests/test_epochs.py's re-election claim on the paper's logistic
   objective (robust tree, 8 nodes, 150 rounds) over seeds 0–3 through
   ``run_sweep_epochs``, each lane bitwise its ``run_epochs``: after the
   crash the epochized runs keep descending and the frozen plans
   (``realize`` + ``run_rfast``) stall;
21. checkpoints — under ``build/chip_smoke_ckpt`` (free disk printed
   first, every directory deleted after its check): a 4.4 GB member
   (zip64) saved and loaded back to the card bitwise; the synchronous
   train at full width, 2 layers, 2 nodes, 4 rounds saving every 2
   against 2 rounds resumed to 4 (the step-4 files bitwise equal); the
   asynchronous train (``uniform``, K 32 in chunks of 16) run to the
   end, its step-16 file alone (with a manifest) resumed to a bitwise
   equal step-32 file, and a rerun with nothing to redo; each file's
   bytes, and the sync file's write and read GB/s.

22. serving, publish and hot swap — phase 4's run with ``--log-every 2
   --publish-dir`` (the consensus average published at k 8 and 16, one
   ``commit_grid`` launch per wave); ``ServeEngine`` (B 4, max_len 64,
   buckets (4, 8, 16), ``drain``, ``poll_every`` 2) on full-width
   rfast-100m from the first published step, the last re-published with
   every slot busy: every request done, served by {first, last} (the
   in-flight ones by the first), the last step loaded once however often
   the drain polls, 1 decode + one prefill entry per bucket used and none
   added across the swap; every request teacher-forced
   through a B = 1 ``prefill_cache`` + ``decode_step`` loop against one
   ``forward`` (1e-4 of each step's largest |logit|), each engine token
   that loop's argmax or a tie within that tolerance (ties counted); the
   step's and the decode-only step's p50 and p99 µs, ``SERVE_TIMED_STEPS``
   decode-only steps with every slot busy (n, p50, p99, max), the kernels
   per decode step and the card's busy share in a ``torch.profiler`` trace of
   ``PROFILE_STEPS`` steps with every slot busy, and the step's bytes
   bound (every parameter but the embedding table, the KV cache);
23. llama3-8b serving — ``launch.serve.main`` at full width and depth
   (8,030,261,248 parameters drawn on the card by a CUDA generator; B 4,
   max_len 64, 16 requests, prompts ≤ 16, ≤ 16 tokens each): every
   request served, 1 decode + one prefill entry per bucket used; then an
   ``immediate`` engine of the same arguments with a 0.9× copy offered
   with every slot busy (two 32 GB trees at the peak): the in-flight
   requests finish on the new weights and no cache entry is added; that
   engine's decode-only steps with every slot busy, ``SERVE_TIMED_STEPS``
   before the swap and as many after (n, p50, p99, max), beside the
   step's bytes bound (30.0 GB);
24. hybrid decode — full-width hymba-1.5b, all 32 layers (B 2, prompt
   192): ``prefill_cache`` and 64 ``decode_step`` calls against one
   teacher-forced ``forward`` at tests/test_serve.py's 2e-3; ``ssm_scan``
   launched 32 times by ``prefill_cache`` and by ``forward``, never by a
   decode step (its SSM step is PyTorch ops, as the reference's decode
   runs ``selective_scan_ref`` outside any kernel); every one of those
   64 calls' inputs (B 2, S 192 and 256, di 3200, N 16, B and C slices
   of the model's projection) recorded and the kernel, called as the
   path calls it, held to ``ssm_scan_plain`` at 1e-4, layer 0's also
   unsplit and split in 3 with the checkpoints.  Phases 22–24 are the
   functions ``phase_serve_rfast``, ``phase_serve_llama`` and
   ``phase_serve_hymba``.

25. zoo serving — the model zoo's decoders at full width, weights drawn
   on the card by a CUDA generator (fp32): olmo-1b (16 layers),
   qwen2.5-3b (36), deepseek-7b (30), phi3.5-moe-42b-a6.6b cut to 8 of
   32 layers and deepseek-v2-236b to 3 of 60 (depth only; every width,
   expert count and top-k as published).  For each: ``prefill_cache`` +
   ``decode_step`` (B 2, S 16, prompt 6; the MoE capacity lifted to 100,
   as tests/test_serve.py lifts it) against one teacher-forced
   ``forward`` at 2e-3; a ``ServeEngine`` (B 4, max_len 64, buckets (4,
   8, 16)) serving 8 requests, one prefill entry per bucket and one
   decode entry; at least ``ZOO_BUSY_STEPS`` decode-only steps with
   every slot busy (p50, p99); kernels per decode step and the card's
   busy share from ``torch.profiler``; peak memory; the step's bound
   (``decode_bound``: a tied head reads the whole table; with MoE every
   expert's bytes, as the dense capacity buffer multiplies them all,
   beside the routed and shared experts' alone);
26. zoo training through ``commit_grid`` — each zoo arch at
   ``--reduced`` through ``launch.train``'s sync rounds (4 nodes, 3
   rounds, ``--loss-prob 0.2``) and deepseek-v2-236b also
   asynchronously (``--scenario straggler``), ``impl kernel`` against
   ``impl plain`` (the last checkpoint's x and z within phase 5's 1e-5),
   ``commit_grid`` launched once per round or wave; then full-width
   olmo-1b cut to 2 of 16 layers (p = 237,240,320) in 3 sync rounds:
   wall s, peak GB and the losses.  Phases 25–26 are the functions
   ``phase_zoo_serve`` and ``phase_zoo_train``.

27. whisper-large-v3 — the enc-dec arch at full width and depth (32
   decoder + 32 encoder layers, 1,603,614,720 parameters drawn on the
   card; 1500 frames drawn with numpy): ``prefill_cache(frontend=)`` +
   ``decode_step`` (B 2, S 16, prompt 6) against one teacher-forced
   ``forward(toks, frames)`` at 2e-3; ``init_cache(frontend=)`` (the
   encoder and the cross caches) + token-wise ``prefill`` against
   ``prefill_cache`` and a decode step from each (tests/
   test_arch_smoke.py's check at full width); at B 4 the encoder's ms a
   call, ``FRONT_STEPS`` decode steps (p50, p99), kernels and device ms
   a step and the busy share, peak memory and the step's bytes bound
   (the decoder's weights without the cross k/v projections, the head,
   the self-KV ring and the cross k/v, ≈ 0.49 GB a batch row); then the
   same arch cut to 2 decoder and 2 encoder layers (226,245,120
   parameters, frames not cut) in 3 lossy sync rounds on 4 nodes
   through ``make_rfast_round`` with ``sync_grad_fn`` and batches of
   (toks, labels, frames), ``impl kernel`` against ``impl plain`` (x and
   z within 1e-5, one ``commit_grid`` launch a round);
28. pixtral-12b — the vision-frontend arch at full width and depth (40
   layers, 12,777,313,280 parameters, 51.1 GB, head dim 160):
   ``prefill_cache`` with 256 patches + ``decode_step`` against
   ``forward(toks, patches)`` at 2e-3 (tests/test_arch_smoke.py's VLM
   check at full width); at B 4 after the 256-patch prefix,
   ``FRONT_STEPS`` decode steps with the same readings as phase 27;
   then ``--reduced`` through ``launch.train`` as phase 26 runs its
   archs (text only, as the reference's train CLI trains it).  Phases
   27–28 are the functions ``phase_whisper`` and ``phase_pixtral``.

29. static analysis (``repro_torch.analysis``, the function
   ``phase_analysis``) — (a) phase 4's run with ``--verify-plans``: the
   same losses, bitwise, and the same ``commit_grid`` launches, its wall
   seconds and the lint's host ms over its plans (``sweep_plan`` with the
   lint against without, median of 5 each); (b) ``run_rfast`` on an
   RF105-corrupted CommPlan raises ``PlanInvariantError`` with no
   ``commit_grid`` launch; (c) ``torchlint.audit_engines`` on the card,
   the kernel route included: 0 diagnostics, nothing skipped; its wave
   loops with the kernel route run again under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync, RF201),
   a gradient that calls ``.item()`` raises there and is RF201 to the
   audit, and two replays of the one-lane loop launch ``commit_grid``
   once per non-empty wave and load no library (RF205); (d)
   ``audit_ops`` over one chunk of (a)'s full-width wave loop, the LM
   gradient's host reads counted apart from the engine's (the engine's
   own must be 0), and the host syncs the sync debug mode sees in one
   more pass and in one gradient, by source line (every one of the
   loop's must be a gradient's); (e) ``python -m repro_torch.analysis
   --all --quick`` in a subprocess: exit 0, 0 diagnostics.

30. multi-device (the function ``phase_mesh``; NCCL refuses two ranks
   on one card, so ranks share it over a gloo group asked for
   explicitly) — (a) a world-1 NCCL group: phase 4's cell at full width
   cut to ``MESH_LAYERS`` (1) of its 12 layers through
   ``run_sweep(mesh=make_sweep_mesh())`` (1 x 1), 7
   ``commit_grid`` launches, every state field against the unsharded
   ``run_sweep`` of the same lane on the card (2e-5; bitwise or not);
   (b) two gloo ranks on cuda:0: the same cell on a (1, 2) mesh (half
   the flat state a rank, ``commit_grid`` at Pf = p_loc, one gather a
   wave), then phase 18(b)'s two lanes at 2 layers on a (2, 1) mesh,
   each rank's lanes held to the unsharded run of the same lanes (the
   ranks take turns at it), with each rank's launches, Pf, collective
   calls, bytes a wave, staged bytes, peak and wall; (c) four gloo ranks:
   the ppermute round (tests/helpers/sharded_equiv.py's sizes) against
   the dense ``make_rfast_round`` (1e-4), Lemma 3 on the slotted layout,
   convergence, and robust mode at 30 % loss (point-to-point staged
   through pinned host buffers); (d) ``audit_engines`` with the mesh
   body (in (b)'s group also its 1 x 2 mesh): 0 diagnostics, and a body
   altered to gather the lane group's node state is RF206.
31. launch tooling (the function ``phase_launch``) — the meta-device
   dry-run's predictions held to the card: (a) ``launch.specs.
   build_train`` of phase 11's cell (full-width rfast-100m, a (4, 1)
   described mesh, seq 128, global batch 16, ``comm="dense"``, fp32,
   ``impl="kernel"``) run once on meta under ``launch.dryrun.measure``,
   then the same case materialized on cuda:0 from seed 0 and run twice
   (``launch.dryrun.run_live``): the argument bytes equal the meta
   prediction exactly, each round launches ``commit_grid`` as often as
   the meta record says, ``FlopCounterMode`` over the real round equals
   the meta aten FLOPs, and the allocator's peak above the arguments
   lies within ``LAUNCH_TEMP_BAND`` (15 %) of the meta temp, plus
   ``LAUNCH_TEMP_SLACK`` (1 MiB) for the allocator's rounding; the round's median
   wall beside the roofline terms; (b) ``build_decode`` of llama3-8b at
   full depth (a 1 x 1 mesh, seq 64, global batch 4, fp32) the same way,
   its meta bytes beside phase 22's ``decode_bound`` and the measured
   step; (c) ``launch.mesh.HW`` beside the card's SM count, maximum SM
   clock and ``total_memory``, with the ``nvidia-smi`` name and power
   limit; (d) ``launch.dryrun.run_case("llama3-8b", "train_4k")`` on meta
   (the production (32, 8) mesh, one rank, tensor-parallel since PR 26)
   with its roofline row: a rank's arguments and temporaries fit a card.
32. tensor parallelism (the function ``phase_tensor_parallel``; eight
   gloo ranks sharing cuda:0, one spawn for phases 32-35, ``tp_spawn``)
   — (a), (b) rfast-100m at full
   width and depth (2 nodes × 4 sequences of 128, fp32, 3 rounds) built
   by ``launch.specs.build_train(comm="ppermute")`` on a (2, 2) and a
   (2, 4) mesh (the first 4 and all 8 ranks): ``"model_axis":
   "tensor"``, a rank's argument bytes equal to the meta case's (at (2,
   2) 5 rows of 62,343,936 fp32 elements and the batch), the collectives
   (calls, bytes, staged bytes) and seconds of each round, the 19,200
   norm scales bitwise equal across each model group, x, z and g_prev
   gathered whole (``models.sharding.gather_flat``) within 1e-4 of the
   dense round's rows (``build_train(comm="dense")``, ``impl="kernel"``,
   the same seeds, run first by the ranks that hold a node's model index
   0), and the round's RF206 audit clean; (c) llama3-8b at full width
   cut to 2 of 32 layers on a model group of 4 (ranks 0–3): the
   tensor-parallel gradient of one sequence of 128, each rank's blocks
   within 1e-4 (of the largest entry) of the unsharded gradient's, which
   the ranks compute in turn, and one loss, the unsharded one.
33. the SSM archs tensor-parallel (the function
   ``phase_tensor_parallel_ssm``; the first four of phase 32's ranks;
   phase 32's functions, which take the config) — (a)
   falcon-mamba-7b at full width cut to 2 of 64 layers (d 4096, d_inner
   8192, vocab 65024 vocab-parallel; 743,305,216 parameters) on a model
   group of 4, no sequence parallelism, no remat: the tensor-parallel
   gradient of one sequence of 128 held to the unsharded one as 32(c)
   holds llama3-8b's, one loss, and ``ssm_scan`` and ``ssm_scan_bwd``
   launched once a layer at a rank's channels, (B 1, S 128, d_inner
   2048, N 16); (b) hymba-1.5b at full width cut to 2 of 32 layers on a
   (2, 2) mesh through ``build_train(comm="ppermute")`` as 32(a) runs
   rfast-100m (2 nodes × 4 × 128 tokens, fp32, 3 rounds, sequence
   parallel): the attention gathered (25 / 5 heads), the embedding and
   head replicated (vocab 32001), the SSM at d_inner 1600 a rank; live
   argument bytes = meta, the replicated leaves (embedding, head, norm
   scales: 102,411,200 elements) bitwise across each model group, x, z
   and g_prev gathered whole within 1e-4 of the dense 2-node round,
   RF206 clean, the scan kernels once forward (and once recomputed) and
   once backward a layer a round; then both scan kernels at the ranks'
   shapes (falcon's, and hymba's (4, 128, 1600, 16)) held to their plain
   twins (phase 14's tolerances) and timed as phase 16 times them, and
   held to their twins at the channels a rank of M 2, 4 or 8 would take
   (hymba 800 and 400, falcon 4096 and 1024), with ``scan_segments``'
   choice at each.
34. the MoE / MLA archs tensor-parallel (the function
   ``phase_tensor_parallel_moe``; phase 32's eight ranks; experts over
   ``model``, MLA's heads column-parallel) — (c)
   phi3.5-moe and deepseek-v2 at ``.reduced()`` width on a (2, 2) mesh
   through ``build_train(comm="ppermute")`` as 32(a) runs rfast-100m (2
   nodes × 4 × 128 tokens, fp32, 3 rounds, sequence parallel): live
   argument bytes = meta, the replicated leaves (the router, MLA's
   down-projections, the norms) bitwise across each model group, x, z
   and g_prev gathered whole within 1e-4 of the dense 2-node round
   (``impl="kernel"``: ``commit_grid``), RF206 clean; (a) phi3.5-moe at
   full width cut to 2 of 32 layers (16 experts, 4 a rank) on a model
   group of 4 and (b) deepseek-v2-236b at full width cut to 1 of 60
   layers (160 experts, 20 a rank; 128 heads, 16 a rank; 12,800 vocab
   rows a rank) on a model group of 8, without sequence parallelism: the
   ranks in turn draw the tree on the card from seed 0, keep their
   blocks on the host and take the unsharded gradient of one sequence
   of 128 (and its routes), keeping their blocks of it on the host; then
   every rank's tensor-parallel gradient on the card, each rank's blocks
   within 1e-4 (of the largest entry) of the unsharded gradient's, one
   loss, the unsharded one, and every rank's routes (each token's
   experts and whether it was kept, forward and recomputed) equal, and
   equal to the unsharded run's, with its drop count; the card's memory
   in use (all ranks) read at each turn and after the gradient.
35. the enc-dec and frontend archs tensor-parallel (the function
   ``phase_tensor_parallel_front``; phase 32's eight ranks; whisper's
   encoder, cross attention and biased MLPs, pixtral's patch prefix) —
   (c) whisper-large-v3 and pixtral-12b at ``.reduced()`` width (16
   frames or patches) on a (2, 2) mesh as 34(c) runs its archs: live
   argument bytes = meta, the replicated leaves bitwise, x, z and g_prev
   gathered whole within 1e-4 of the dense 2-node round
   (``commit_grid``), RF206 clean; (a) whisper-large-v3 at full width
   cut to 2 + 2 of its 32 + 32 layers, one sequence of 128 tokens over
   its 1500 frames, with sequence parallelism on a model group of 4
   (self, cross and encoder attention on 5 heads a rank, the encoder's
   stream sequence-parallel, the vocab replicated) and of 8 (the three
   attention blocks gathered, the encoder's stream replicated); (b)
   pixtral-12b at full width cut to 2 of 40 layers, its 256 patch rows
   before 128 tokens, sequence- and vocab-parallel on a model group of
   8: each held to the unsharded gradient as 34(a) holds phi3.5-moe's.
36. prefill and decode with the ``model`` axis tensor-parallel (the
   function ``phase_tensor_parallel_serve``; phase 32's eight ranks; the
   cache laid out by the reference's ``cache_pspecs``,
   ``launch.specs.serving_layout``) — fp32, weights from seed 0, each
   case's prompt prefilled by ``prefill_cache`` (sequence-parallel but
   for deepseek-v2) and 8 teacher-forced ``decode_step``s (16 for (c),
   whose steps wrap its ring), every step's logits (gathered
   over the vocab) within 1e-5 of the largest |logit| of the unsharded
   run on the card and the cache, gathered, within 1e-5 of its after the
   last step (the unsharded run of the whole batch, cut to the node's
   rows, on each node's model index 0, in its turn: the ranks draw the
   tree in turns and keep their blocks): (a)
   llama3-8b at full width cut to 2 of 32 layers on M 8 (the ring by
   KV heads, one a rank) and M 4, B 2, prompt 256, max_len 512; (b)
   qwen2.5-3b at 2 of 36 layers on M 8, the ring by slots (ranks 4-7
   start empty) and, with ``cache_seq_shard=False``, by head dim; (c)
   hymba-1.5b at 2 of 32 layers on M 8, its 1024-slot ring by slots
   (prompt 1016: the 16 steps wrap from rank 7's slot 1023 to rank 0's
   slot 0), its SSM state by channels, the head replicated and its
   logits bitwise equal across the group, ``ssm_scan`` launched once a
   layer at the prefill at a rank's channels (2, 1016, 400, 16); (d)
   falcon-mamba-7b at 2 of 64 layers on M 8 (channels, vocab-parallel,
   ``ssm_scan`` at (2, 256, 1024, 16)); the first scan call of each of
   (c) and (d) on model index 0 held to the plain twin; (e) rfast-100m at full width and
   depth on (2, 4), B 4 (its rows over ``data``, heads at M 4), and
   ``build_prefill`` / ``build_decode`` live on the card with argument
   bytes equal to the meta case's; (f4) whisper-large-v3 at full width
   cut to 2 + 2 of its 32 + 32 layers, B 2, its 1500 frames (drawn
   after the tokens from the seeded CUDA generator) and a prompt of 256,
   max_len 512, on M 4: the self ring and the cross caches by KV heads
   (5 a rank), the encoder's stream sequence-parallel, the head
   replicated; (f8) the same on M 8: the ring by slots, the cross caches
   by head dim (8 of 64), the three attention blocks gathered, the
   encoder's stream replicated; both hold the cross caches too and
   ``init_cache(frontend=)``'s cross blocks to the prefill's, and their
   replicated logits bitwise across the group; (g) pixtral-12b at 2 of
   40 layers on M 8, its 256 patch rows before a prompt of 256, the
   ring by KV heads (one a rank), vocab-parallel, max_len 1024; (h)
   phi3.5-moe-42b-a6.6b at 2 of 32 layers on M 8, B 2, prompt 256,
   max_len 512: the ring by KV heads (one a rank), 2 of 16 experts a
   rank, the prefill sequence-parallel, then 4 ``decode_step_slots``
   from an empty cache with the rows at positions 5 and 0 (each row
   routed alone) held to the unsharded ones; (i) deepseek-v2-236b at 1
   of 60 layers on M 8 (16 MLA heads and 20 of 160 experts a rank, the
   prefill not sequence-parallel, as the reference opts out): MLA's
   latent ``c`` by slots (64 of 512 a rank), ``kr`` whole, decoded in
   the absorbed form (``models.sharding.latent_attend``); (j) the same
   with ``cache_seq_shard=False``: ``c`` by latent dim (64 of 512); (k)
   deepseek-v2-236b at 1 of 60 layers on (2, 4), B 4 (2 rows a node),
   ``c`` by slots (128 of 512 a rank), 40 of 160 experts a rank, at the
   published ``capacity_factor`` 1.25: the steps run inside the data
   group's ``use_batch_group``, so the MoE layer keeps and drops the
   choices the whole batch's routing does (one gather of the experts'
   counts over the 2 data ranks a layer); the whole batch's dropped
   choices, each node's and how many choices routing a node's rows alone
   would keep or drop otherwise are printed, and the nodes' drops must
   sum to the whole batch's.  The MoE cases' routes and drops (each
   ``moe._slots`` call's experts and kept choices, at the prefill and
   every step) equal the unsharded run's on the rank's rows.  A decode
   step's collectives are the layout's
   count (heads: 1 + 2L sums; slots: 7L gathers, L maxes, 1 + 2L sums;
   head dim: 8L gathers, 1 + 2L sums; hymba: 4L gathers, L maxes, 4L
   sums, L all-to-alls; falcon: 1 + 2L sums, L all-to-alls; whisper by
   heads: 3L sums; by slots and head dim: 11L gathers, L maxes, 3L sums;
   deepseek-v2 by slots: L gathers, L maxes, 1 + 3L sums; by latent
   dim: 2L gathers, 1 + 3L sums; (k) also L gathers over the data
   group, each counted by its group's size); each rank's cache bytes (the ring's
   or ``c``'s, and the cross caches' apart) are 1 / M of its rows', and
   its ``kr`` all of its rows'; emitted beside them a rank's weight
   bytes, the collectives of a prefill and a decode step (calls, bytes,
   staged bytes), the seconds of each (gloo's host path) and the card's
   memory.

Each of phases 17–36 prints its wall seconds, peak memory or
``commit_grid`` launches (counters zeroed just before a run and read
just after).  Every JSON line carries ``t_s``, the seconds since the
script started, so a phase's seconds are the gap to the next phase's
first line.  Then one ``{"kernels": [...]}`` line, the ``nvidia-smi``
line, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

if (SRC / "repro_torch").is_dir():
    # the H100 SXM data-sheet rates have one home, the port's
    # launch/mesh.py (main() refuses to run without the package)
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import (BF16_FLOP_PER_S, FP32_FLOP_PER_S,
                                         H100_SMS, HBM_BYTES_PER_S,
                                         MUFU_PER_CLOCK_SM, TF32_FLOP_PER_S)
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3   # fp32 products in 3xTF32
FP32_TOL = 1e-5              # tests/test_kernels.py's commit_grid tolerance
BF16_TOL = 3e-2              # tests/test_kernels.py's bf16 tolerance
FLASH_FWD_TOL = 2e-5         # tests/test_kernels.py's flash tolerances:
FLASH_GRAD_TOL = 2e-4        # fp32 forward, fp32 gradients,
FLASH_BF16_TOL = 2e-2        # and bf16
# (B, H, KV, Sq, Sk, D, causal, window); bq = bk = 8 divides every S
FLASH_SMALL = [
    (1, 4, 4, 128, 128, 32, True, None),
    (2, 8, 2, 256, 256, 64, False, None),
    (1, 5, 1, 192, 192, 128, True, 128),
    (1, 10, 2, 128, 256, 64, True, None),     # Sq < Sk, GQA 5
    (1, 4, 1, 256, 128, 32, True, None),      # Sq > Sk
    (1, 5, 5, 200, 200, 64, True, 5),         # window below one tile
    (2, 4, 4, 200, 200, 48, True, 100),       # ragged window, D = 48
    (1, 3, 1, 104, 104, 35, True, 50),        # D % 4 != 0: padded to 36
]
# bf16 only: a head dim the tensor-core kernels take by padding
# (D % 8 != 0) and one with a half-filled 16-column k-step (D % 16 != 0)
FLASH_SMALL_BF16 = [
    (1, 4, 2, 136, 136, 36, True, None),      # D = 36
    (2, 4, 2, 136, 72, 40, True, 96),         # D = 40, Sq > Sk, window
]
# attention widths of src/repro/configs/{llama3_8b,hymba_1_5b,rfast_100m}.py
# (hymba's attn_window 1024); rfast-100m at the train phase's batch and
# sequence
FLASH_FULL = [
    ("llama3-8b", dict(B=1, S=4096, H=32, KV=8, D=128, window=None)),
    ("hymba-1.5b", dict(B=1, S=4096, H=25, KV=5, D=64, window=1024)),
    ("rfast-100m", dict(B=4, S=128, H=12, KV=4, D=64, window=None)),
]
TRAIN_ARGS = ["--arch", "rfast-100m", "--nodes", "4", "--topology",
              "binary_tree", "--scenario", "uniform", "--steps", "4",
              "--batch-per-node", "4", "--seq", "128", "--seed", "0"]
SYNC_ARGS = ["--arch", "rfast-100m", "--nodes", "4", "--topology",
             "binary_tree", "--steps", "3", "--batch-per-node", "4",
             "--seq", "128", "--seed", "0", "--log-every", "1"]
SYNC_RUNS = [("sync", []),
             ("lossy+momentum", ["--loss-prob", "0.2", "--momentum", "0.9"])]
# (Kw, Ka, Ko): the binary tree's slot counts, and wider ones
NODE_SLOTS = [(1, 2, 1), (2, 3, 2)]
ROUTE_TOL = 1e-5             # the round routes agree to this, relative
SCAN_FP32_TOL = 1e-4         # tests/test_kernels.py's scan tolerances:
SCAN_BF16_TOL = 3e-2         # fp32 and bf16
SCAN_GRAD_TOL = 1e-4         # SelectiveScanFn vs plain autograd, relative
# the checkpoint spacing the scan gradient's own bound counts: the kernel
# reads checkpoints every CKPT_EVERY = 8 steps only to fit its shared
# memory, so the 8x more checkpoint bytes are a cost of its design, not
# part of the least work (its bound at T = 8 is reported beside)
SCAN_BOUND_CKPT_EVERY = 64
# (B, S, di, N): tests/test_kernels.py:228-232, then ragged di, S and N
SCAN_SMALL = [(1, 64, 16, 8), (2, 128, 64, 16), (1, 256, 32, 16)] + [
    (2, S, di, N) for di in (200, 3200) for S in (1, 100, 129)
    for N in (4, 16)]
# (name, (B, S, di, N), dt_rank): hymba-1.5b's train shape (4 x 128
# tokens per gradient, d_inner 3200), and the op widths of hymba-1.5b and
# falcon-mamba-7b (d_inner 8192) at S 4096; src/repro/configs/
SCAN_TRAIN = ("hymba-1.5b train", (4, 128, 3200, 16), 100)
SCAN_TIMED = [SCAN_TRAIN, ("hymba-1.5b op", (1, 4096, 3200, 16), 100),
              ("falcon-mamba-7b op", (1, 4096, 8192, 16), 256)]
HYMBA_LAYERS = 2             # of hymba-1.5b's 32, at full width
# phases 17-19: the engines, the fleet sweep and the baselines
STATE_FIELDS = ("x", "v", "z", "g_prev", "rho", "rho_buf")
EVENT_TOL = 1e-4             # event vs wavefront, of each field's max
FLEET_TOL = 1e-5             # fleet lane vs run_rfast, card vs CPU runs
LOGISTIC_N = 7               # the paper's §VI-A experiment: 7 nodes,
LOGISTIC_GAMMA = 1e-3        # make_logistic_problem's defaults (m 12000,
FLEET_K = 7000               # d 784, batch 32), label-sorted shards
FLEET_EVAL = 1000
TRACE_K = 200                # events a lane of the traced short fleet
FLEET_LANES = [(sc, seed) for sc in ("straggler", "packet_loss")
               for seed in range(4)]
LOSS_TARGET = 2e-3           # mean loss that time-to-target reads
SYNC_ROUNDS = 300            # the sync baselines' rounds, and the async
ASYNC_K = 2100               # ones' events: 2100 gradients each
# (runner, topology): the graphs the reference's benches give each
# baseline (benchmarks/bench_straggler.py); push-pull on R-FAST's tree
BASELINES = [("push_pull_sync", "binary_tree"), ("sab", "directed_ring"),
             ("ring_allreduce", None), ("dpsgd", "undirected_ring"),
             ("adpsgd", "undirected_ring"), ("osgp", "directed_ring")]
# phases 20-21: dynamic membership and checkpoints
CHURN_ARGS = ["--arch", "rfast-100m", "--scenario", "churn", "--topology",
              "binary_tree", "--nodes", "4", "--steps", "20", "--log-every",
              "5", "--impl", "kernel", "--batch-per-node", "4", "--seq",
              "128", "--seed", "0"]
CHURN_K, CHURN_EVERY = 80, 20     # K = steps x nodes; train.py's chunk
RF_K, RF_EVERY = 160, 40          # root_failover on robust_tree, n 4
REELECT_N, REELECT_K = 8, 1200    # tests/test_epochs.py's re-election
REELECT_GAMMA, REELECT_EVERY = 2e-3, 100   # claim: 150 rounds of 8
REELECT_SEEDS = [0, 1, 2, 3]
CKPT_COMMON = ["--arch", "rfast-100m", "--nodes", "2", "--topology",
               "binary_tree", "--batch-per-node", "4", "--seq", "128",
               "--seed", "0", "--impl", "kernel"]
CKPT_SYNC_ARGS = CKPT_COMMON + ["--log-every", "1", "--ckpt-every", "2"]
CKPT_ASYNC_ARGS = CKPT_COMMON + ["--scenario", "uniform", "--steps", "16",
                                 "--log-every", "8", "--ckpt-every", "8"]
ZIP64_FLOATS = 1_100_000_000      # one 4.4 GB member: past zip's 4 GiB
HYMBA_ARGS = ["--arch", "hymba-1.5b", "--nodes", "4", "--topology",
              "binary_tree", "--steps", "3", "--batch-per-node", "4",
              "--seq", "128", "--seed", "0", "--log-every", "1", "--impl",
              "kernel"]
# phases 22-24: serving.  Phase 4's run with a chunk every 2 steps a node:
# the consensus average published at k 8 and 16
PUBLISH_ARGS = TRAIN_ARGS + ["--log-every", "2"]
SERVE_B, SERVE_MAX_LEN, SERVE_BUCKETS = 4, 64, (4, 8, 16)
SERVE_REQUESTS = 24          # the first four fill the slots, one of each
SERVE_FIRST_PROMPTS = [3, 7, 12, 16]    # bucket, when the swap is staged
SERVE_TOL = 1e-4             # loop vs forward, of each step's max |logit|
PROFILE_STEPS = 5            # decode steps in the launch-count trace
SERVE_TIMED_STEPS = 100      # decode-only steps timed with every slot busy
TOP_KERNELS = 6              # kernels by device time a trace reports
LLAMA_SERVE_ARGS = ["--arch", "llama3-8b", "--batch", "4", "--max-len",
                    "64", "--requests", "16", "--max-prompt", "16",
                    "--max-gen", "16", "--seed", "0"]
HYMBA_SERVE_B, HYMBA_PROMPT, HYMBA_DECODE = 2, 192, 64
SERVE_TF_TOL = 2e-3          # tests/test_serve.py's teacher-forced rtol/atol
# phases 25-26: the model zoo.  (arch, layers kept or None for all): the
# MoE archs cut in depth only (166 GB and 957 GB at full depth)
ZOO_SERVE = [("olmo-1b", None), ("qwen2.5-3b", None), ("deepseek-7b", None),
             ("phi3.5-moe-42b-a6.6b", 8), ("deepseek-v2-236b", 3)]
# their parameters at those depths, every leaf (norms and biases too)
ZOO_PARAMS = {"olmo-1b": 1_176_764_416, "qwen2.5-3b": 3_085_938_688,
              "deepseek-7b": 6_910_365_696,
              "phi3.5-moe-42b-a6.6b": 10_665_205_760,
              "deepseek-v2-236b": 12_964_930_560}
ZOO_TF_B, ZOO_TF_S, ZOO_TF_PROMPT = 2, 16, 6   # tests/test_serve.py's
ZOO_TF_CAPACITY = 100.0      # tests/test_serve.py lifts the MoE capacity
ZOO_PROMPTS = [3, 7, 12, 16, 2, 5, 9, 14]      # every bucket used
ZOO_GEN = 6                  # tokens a request
ZOO_BUSY_STEPS = 20          # busy decode-only steps timed, at least
ZOO_TRAIN = [a for a, _ in ZOO_SERVE]
ZOO_TRAIN_ARGS = ["--reduced", "--nodes", "4", "--topology", "binary_tree",
                  "--steps", "3", "--batch-per-node", "4", "--seq", "64",
                  "--seed", "0", "--log-every", "1", "--ckpt-every", "3"]
# (tag, extra arguments, archs): every zoo arch in lossy sync rounds, the
# MLA + MoE arch also asynchronously
ZOO_TRAIN_RUNS = [("sync", ["--loss-prob", "0.2"], ZOO_TRAIN),
                  ("async", ["--scenario", "straggler"],
                   ["deepseek-v2-236b"])]
BACKEND_TOL = 1e-5           # phase 5's kernel vs plain tolerance
OLMO_TRAIN_LAYERS = 2        # of olmo-1b's 16 at full width: ≈ 57 GB peak
OLMO_TRAIN_P = 237_240_320
OLMO_TRAIN_ARGS = ["--arch", "olmo-1b", "--nodes", "4", "--topology",
                   "binary_tree", "--steps", "3", "--batch-per-node", "4",
                   "--seq", "128", "--seed", "0", "--log-every", "1",
                   "--impl", "kernel"]
# phases 27-28: the enc-dec and frontend archs at full width and depth;
# their parameters, every leaf
WHISPER_PARAMS = 1_603_614_720
PIXTRAL_PARAMS = 12_777_313_280
FRONT_B = 4                  # the timed decode batch
FRONT_PROMPT = 4             # text tokens prefilled before the timed steps
FRONT_STEPS = 40             # decode steps timed (at least ZOO_BUSY_STEPS)
WHISPER_MAX_LEN = 64         # 4 + 3 + 40 + 5 decode positions fit
PIXTRAL_MAX_LEN = 320        # 256 patches + the same
ENCODER_REPS = 5             # init_cache calls timed (the encoder at B 4)
WHISPER_TOKENWISE = 8        # prompt of the token-wise prefill check
WHISPER_TRAIN_LAYERS = 2     # decoder and encoder layers of 32 each
WHISPER_TRAIN_P = 226_245_120
WHISPER_TRAIN_NODES, WHISPER_TRAIN_ROUNDS = 4, 3
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 4, 64
WHISPER_TRAIN_LOSS = 0.2
# phase 30: multi-device on this card
MESH_FIELDS = ("x", "v", "z", "g_prev", "rho", "rho_buf", "v_hist",
               "rho_hist")
MESH_TOL = 2e-5              # tests/helpers/mesh_sweep_equiv.py's tolerance
MESH_GAMMA = 3e-3            # train.py's default --gamma, as phase 4 runs
MESH_TIMEOUT_S = 900.0       # a rank's collectives (its turn at a barrier)
MESH_JOIN_S = 900.0          # a spawn's ranks, all of them
ROUND_TOL = 1e-4             # tests/helpers/sharded_equiv.py's tolerance
# 30(a) and 30(b)'s (1, 2) mesh run phase 4's cell at full width cut to
# this depth (of 12): its checks do not depend on the depth, and the
# state's host copies, which took most of the two spawns, scale with it
MESH_LAYERS = 1
# phase 31: the launch tooling's predictions held to the card
LAUNCH_TEMP_BAND = 0.15      # live peak above the arguments vs meta temp,
LAUNCH_TEMP_SLACK = 2**20    # relative, plus bytes for allocator rounding
LAUNCH_TRAIN = dict(seq=128, global_batch=16, comm="dense", impl="kernel")
LAUNCH_DECODE = dict(seq=64, global_batch=4)
SHARDED_N, SHARDED_P = 4, 16             # and its sizes: a binary tree of
SHARDED_ROUNDS, SHARDED_GAMMA = 200, 0.06    # 4, p 16, 200 rounds; robust
ROBUST_P, ROBUST_ROUNDS, ROBUST_GAMMA, ROBUST_LOSS = 8, 300, 0.05, 0.3
# phase 32: the model axis tensor-parallel, ranks of this card over gloo.
# rfast-100m at full width and depth, 2 nodes x 4 sequences of 128, fp32,
# on (nodes, model ranks) meshes; the ranks of a spawn of TP_WORLD take
# each mesh's first ranks
TP_WORLD = 8
TP_MESHES = [(2, 2), (2, 4)]
TP_TRAIN = dict(seq=128, global_batch=8, impl="kernel", seed=0)
TP_ROUNDS = 3
TP_TOL = 1e-4                # of each field's (each leaf's) largest entry
# rank -> the node whose dense rows it holds to its gathered ones: model
# index 0 of each node on (2, 2) (ranks 0, 2) and (2, 4) (ranks 0, 4)
TP_REF_NODES = {0: 0, 2: 1, 4: 1}
TP_P_2X2 = 62_343_936        # a rank's flat width on (2, 2): half of
                             # every sharded leaf and the 19,200 norm scales
# llama3-8b at full width cut to 2 of 32 layers, one sequence of 128, on
# a model group of 4 (ranks 0-3)
TP_LLAMA_LAYERS, TP_LLAMA_B, TP_LLAMA_S, TP_LLAMA_M = 2, 1, 128, 4
# phase 33: the SSM archs' model axis tensor-parallel, ranks of this card
# over gloo.  (b) hymba-1.5b at full width cut to 2 of 32 layers, phase
# 32's cell (2 nodes x 4 sequences of 128, fp32) on a (2, 2) mesh;
# (a) falcon-mamba-7b at full width cut to 2 of 64 layers, one sequence
# of 128, on a model group of 4 (all the ranks)
TP_HYMBA_LAYERS, TP_HYMBA_MESH, TP_HYMBA_ROUNDS = 2, (2, 2), 3
TP_HYMBA_REF_NODES = {0: 0, 2: 1}     # model index 0 of each node
# hymba's replicated leaves a rank: the embedding and the head (vocab
# 32001 does not divide over model) and the 2L + 1 norm scales
TP_HYMBA_REPLICATED = 2 * 32001 * 1600 + (2 * 2 + 1) * 1600
TP_FALCON_LAYERS, TP_FALCON_B, TP_FALCON_S, TP_FALCON_M = 2, 1, 128, 4
TP_FALCON_DI = 8192                   # d_inner: 2048 a rank
TP_FALCON_P = 743_305_216             # its 2-layer tree, unsharded
# the scan kernels at the ranks' shapes (B, S, d_inner / M, N), dt_rank
TP_SCAN_SHAPES = [
    ("falcon-mamba-7b rank (M 4)", (1, 128, 2048, 16), 256),
    ("hymba-1.5b rank (M 2)", (4, 128, 1600, 16), 100)]
# and held to their twins (not timed) at the other widths a rank of M 2,
# 4, 8 gives each arch: hymba's 800 and 400 (a ragged tail of the 32
# channel tile), falcon-mamba's 4096 and 1024
TP_SCAN_WIDTHS = [("hymba-1.5b rank (M 4)", (4, 128, 800, 16), 100),
                  ("hymba-1.5b rank (M 8)", (4, 128, 400, 16), 100),
                  ("falcon-mamba-7b rank (M 2)", (1, 128, 4096, 16), 256),
                  ("falcon-mamba-7b rank (M 8)", (1, 128, 1024, 16), 256)]
# phase 34: the MoE / MLA archs' model axis tensor-parallel, ranks of this
# card over gloo.  (c) both archs at .reduced() width, phase 32's cell on
# a (2, 2) mesh; (a), (b) at full width cut in depth, one sequence of
# 128, no sequence parallelism: (arch, layers, model group of the first
# ranks, experts a rank, heads a rank, parameters of the cut tree)
TP_MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")
# 34(c), 35(c): phase 32's cell of each arch at .reduced() width
TP_REDUCED_MESH, TP_REDUCED_ROUNDS = (2, 2), 3
TP_REDUCED_REF_NODES = {0: 0, 2: 1}   # model index 0 of each node
TP_MOE_B, TP_MOE_S = 1, 128
TP_MOE_FULL = [("phi3.5-moe-42b-a6.6b", 2, 4, 4, 8, 2_863_308_800),
               ("deepseek-v2-236b", 1, 8, 20, 16, 5_020_697_600)]
TP_MOE_CARD_GB = 80.0                 # the card's memory, all ranks
# phase 35: the enc-dec and frontend archs' model axis tensor-parallel,
# ranks of this card over gloo.  (c) both archs at .reduced() width, phase
# 32's cell on a (2, 2) mesh; (a) whisper-large-v3 at full width cut to
# 2 + 2 of its 32 + 32 layers, one sequence of 128 tokens over its 1500
# frames, (b) pixtral-12b at full width cut to 2 of 40 layers, its 256
# patch rows before 128 tokens, each sequence-parallel on a model group
# of the first ranks: (arch, layers, model group, attention heads a rank
# (None: the three attention blocks gathered), the encoder's stream
# sequence-parallel (None: no encoder), vocab-parallel, parameters of the
# cut tree)
TP_FRONT_ARCHS = ("whisper-large-v3", "pixtral-12b")
TP_FRONT_B, TP_FRONT_S = 1, 128
TP_FRONT_FULL = [("whisper-large-v3", 2, 4, 5, True, False, 226_245_120),
                 ("whisper-large-v3", 2, 8, None, False, False, 226_245_120),
                 ("pixtral-12b", 2, 8, 4, None, True, 1_918_919_680)]

# phase 36: prefill and decode with the model axis tensor-parallel, ranks
# of this card over gloo, fp32, weights from seed 0: each case's prompt
# prefilled (sequence-parallel but where the arch opts out) and its
# decode steps (TP_SERVE_STEPS teacher-forced ones unless the case says
# otherwise), held to the unsharded run.  A case: its arch cut to ``layers``
# (None: all), its (nodes, model ranks) mesh of the first ranks, the
# global batch, prompt and max_len, cache_seq_shard, the layouts
# expected, the blocks gathered, whether the head is vocab-parallel, and
# the collectives of one decode step (L layers: module docstring)
TP_SERVE_TOL = 1e-5          # of the largest |logit| / cache entry
TP_SERVE_STEPS = 8           # (c)'s 16 wrap its ring across the ranks
# a case's decode_step_slots run: from an empty cache, the rows at these
# positions, TP_SERVE_SLOT_STEPS steps
TP_SERVE_SLOT_POS, TP_SERVE_SLOT_STEPS = (5, 0), 4


def _serve_case(case, arch, layers, mesh, batch, prompt, max_len,
                seq_shard, kv, ssm, gathered, vocab_parallel, calls,
                cross=None, latent=None, seq_parallel=True, slots=False,
                steps=TP_SERVE_STEPS, data_calls=None):
    """``calls``: a decode step's collectives over the model group;
    ``cross``: the enc-dec arch's cross caches' layout (None: no
    encoder); ``latent``: the MLA arch's latent's (None: no MLA);
    ``seq_parallel``: the prefill's; ``slots``: also a
    ``decode_step_slots`` run; ``steps``: the decode steps;
    ``data_calls``: a decode step's collectives over the data group
    (the batch rows split over nodes: an MoE layer's gather of the
    experts' counts).  A frontend arch's frames or patches come with the
    prompt."""
    return dict(case=case, arch=arch, layers=layers, mesh=mesh,
                batch=batch, prompt=prompt, max_len=max_len,
                seq_shard=seq_shard, kv=kv, ssm=ssm, gathered=gathered,
                vocab_parallel=vocab_parallel, decode_calls=calls,
                cross=cross, latent=latent, seq_parallel=seq_parallel,
                slots=slots, steps=steps, data_calls=data_calls or {})



TP_SERVE = [
    _serve_case("a8", "llama3-8b", 2, (1, 8), 2, 256, 512, True, "heads",
                None, [], True, {"all_reduce_sum": 5}),
    _serve_case("a4", "llama3-8b", 2, (1, 4), 2, 256, 512, True, "heads",
                None, [], True, {"all_reduce_sum": 5}),
    _serve_case("b_slots", "qwen2.5-3b", 2, (1, 8), 2, 256, 512, True,
                "slots", None, ["layers/attn"], True,
                {"all_gather_seq": 14, "all_reduce_max": 2,
                 "all_reduce_sum": 5}),
    _serve_case("b_head_dim", "qwen2.5-3b", 2, (1, 8), 2, 256, 512, False,
                "head_dim", None, ["layers/attn"], True,
                {"all_gather_seq": 16, "all_reduce_sum": 5}),
    _serve_case("c", "hymba-1.5b", 2, (1, 8), 2, 1016, 2048, True, "slots",
                "channels", ["layers/attn"], False,
                {"all_gather_seq": 8, "all_reduce_max": 2,
                 "all_reduce_sum": 8, "all_to_all": 2}, steps=16),
    _serve_case("d", "falcon-mamba-7b", 2, (1, 8), 2, 256, 512, True, None,
                "channels", [], True, {"all_reduce_sum": 5,
                                       "all_to_all": 2}),
    _serve_case("e", "rfast-100m", None, (2, 4), 4, 256, 512, True,
                "heads", None, [], True, {"all_reduce_sum": 25}),
    # whisper-large-v3 at 2 + 2 layers over its 1500 frames: on M 4 self
    # and cross by heads, the encoder's stream sequence-parallel, 3L sums;
    # on M 8 the self ring by slots, the cross caches by head dim, the
    # three attention blocks gathered (self 7 leaves, cross wq, bq, wo and
    # its p·v slice: 11L gathers; L maxes; the ring's merge, the cross
    # scores and the MLP: 3L sums)
    _serve_case("f4", "whisper-large-v3", 2, (1, 4), 2, 256, 512, True,
                "heads", None, [], False, {"all_reduce_sum": 6},
                cross="heads"),
    _serve_case("f8", "whisper-large-v3", 2, (1, 8), 2, 256, 512, True,
                "slots", None, ["enc_layers/attn", "layers/attn",
                                "layers/cross"], False,
                {"all_gather_seq": 22, "all_reduce_max": 2,
                 "all_reduce_sum": 6}, cross="head_dim"),
    # pixtral-12b at 2 of 40 layers, 256 patch rows before a prompt of
    # 256 tokens: one KV head a rank, vocab-parallel, 1 + 2L sums
    _serve_case("g", "pixtral-12b", 2, (1, 8), 2, 256, 1024, True,
                "heads", None, [], True, {"all_reduce_sum": 5}),
    # phi3.5-moe-42b-a6.6b at 2 of 32 layers: one KV head and 2 of 16
    # experts a rank, the prefill sequence-parallel, 1 + 2L sums; then
    # decode_step_slots, each row routed alone
    _serve_case("h", "phi3.5-moe-42b-a6.6b", 2, (1, 8), 2, 256, 512, True,
                "heads", None, [], True, {"all_reduce_sum": 5}, slots=True),
    # deepseek-v2-236b at 1 of 60 layers, 16 MLA heads and 20 of 160
    # experts a rank, the prefill not sequence-parallel (the reference's
    # opt-out): c by slots (64 of 512) and kr whole, a layer's gather of
    # [q̃ | qr], the merge's max and sum, the MLA and MoE blocks' sums (L
    # gathers, L maxes, 1 + 3L sums); (j) c by latent dim (64 of 512): the
    # gather, the partial scores' sum, the gather of p·c (2L gathers, 1 +
    # 3L sums)
    _serve_case("i", "deepseek-v2-236b", 1, (1, 8), 2, 256, 512, True, None,
                None, [], True, {"all_gather_seq": 1, "all_reduce_max": 1,
                                 "all_reduce_sum": 4},
                latent="slots", seq_parallel=False),
    _serve_case("j", "deepseek-v2-236b", 1, (1, 8), 2, 256, 512, False, None,
                None, [], True, {"all_gather_seq": 2, "all_reduce_sum": 4},
                latent="latent_dim", seq_parallel=False),
    # (k) deepseek-v2-236b at 1 of 60 layers on (2, 4), the batch of 4
    # rows over data (2 a node), c by slots (128 of 512 a rank), 40 of 160
    # experts a rank at the published capacity_factor 1.25: the MoE layer
    # routes the whole batch's tokens, as the reference's one program
    # does.  Over the model group (i)'s calls at M 4; over the data group
    # one gather of the experts' counts a layer
    _serve_case("k", "deepseek-v2-236b", 1, (2, 4), 4, 256, 512, True, None,
                None, [], True, {"all_gather_seq": 1, "all_reduce_max": 1,
                                 "all_reduce_sum": 4},
                latent="slots", seq_parallel=False,
                data_calls={"all_gather_flat": 1})]
# 36(e)'s build functions materialized on the card, on its mesh
TP_SERVE_LIVE = {"mesh": (2, 4), "prefill": dict(seq=256, global_batch=4),
                 "decode": dict(seq=512, global_batch=4)}


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line: the phase's record, ``t_s`` the seconds since the
    script started (each phase's seconds are the gaps between them)."""
    print(json.dumps({"phase": phase,
                      "t_s": round(time.perf_counter() - T_START, 1),
                      **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, one event pair per call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median device time of one ``fn()`` in ms: ``launches`` calls
    captured in a CUDA graph and replayed between one event pair, so the
    host's time per call (a wrapper's checks, its ctypes call), which
    :func:`cuda_ms` brackets too, is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


# --------------------------------------------------------------------- #
# commit_grid cases
# --------------------------------------------------------------------- #
def grid_case(P, dtype, *, B=5, ka=3, ko=2, clamp=False, seed=0):
    """Random sources and gather tables on the card (the layout of
    tests/test_kernels.py's cases); ``clamp`` puts drop-sentinel and
    negative rows in the tables."""
    import torch
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=g, device=dev,
                                      dtype=torch.int32)
    Nz, Nri, Nr = 4 * B, 40, 16
    kw = dict(idx_z=ri(Nz, B), idx_g=ri(Nz, B), idx_ri=ri(Nri, B, ka),
              idx_rb=ri(Nr, B, ka), idx_ro=ri(Nr, B, ko),
              a_self=torch.rand(B, generator=g, device=dev),
              mask=ri(2, B, ka).float(),
              a_out=torch.rand(B, ko, generator=g, device=dev),
              z_src=a(Nz, P), g_new=a(B, P), go_src=a(Nz, P),
              ri_src=a(Nri, P), rb_src=a(Nr, P), ro_src=a(Nr, P))
    if clamp:
        kw["idx_ri"][:, -1] = 10_000
        kw["idx_rb"][:, -1] = 2 * Nr
        kw["idx_ro"][0] = -5
        kw["mask"][:, -1] = 0.0
    return kw


def main_path_case(res_p: int, seed: int = 0):
    """commit_grid's inputs at the train run's widest wave: its real
    gather tables over sources with the run's row counts (nodes (n·4),
    ρ history (H·E), ρ/ρ̃ (2E)) at the run's flat width."""
    import numpy as np
    import torch
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.schedule import (build_wavefront_plan,
                                           grid_gather_tables)
    from repro_torch.core.topology import get_topology
    from repro_torch.kernels.rfast_update.grid import commit_grid_flops

    n, K = 4, 16
    topo = get_topology("binary_tree", n)
    plan = build_comm_plan(topo)
    sched = get_scenario("uniform", n).realize(topo, K, seed=0).schedule
    H = int(sched.D) + 2
    wf = build_wavefront_plan(sched, plan, H, break_every=K)
    w = int(np.argmax(wf.sizes))
    s = int(wf.sizes[w])
    tabs = grid_gather_tables(wf.agent[w, :s], wf.rslot_rho[w, :s],
                              wf.hist_epos[w, :s], wf.rho_gidx[w, :s],
                              e_a_flat=wf.e_a, ko=plan.ko)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda r: torch.randn(r, res_p, generator=g, device=dev)
    nodes, hist, rho2 = rows(4 * n), rows(H * wf.e_a), rows(2 * wf.e_a)
    it = lambda t: torch.as_tensor(np.ascontiguousarray(t, np.int32),
                                   device=dev)
    ft = lambda t: torch.as_tensor(np.ascontiguousarray(t, np.float32),
                                   device=dev)
    kw = dict(idx_z=it(tabs[0]), idx_g=it(tabs[1]), idx_ri=it(tabs[2]),
              idx_rb=it(tabs[3]), idx_ro=it(tabs[4]),
              a_self=ft(wf.a_self[w, :s]), mask=ft(wf.a_val[w, :s]),
              a_out=ft(wf.out_wt[w, :s]), z_src=nodes, g_new=rows(s),
              go_src=nodes, ri_src=hist, rb_src=rho2, ro_src=rho2)
    # bytes the function must move: every distinct source row once
    # (z/g_prev share the node array, ρ̃/ρ-out the ρ array), the lane
    # gradients, the tables, and every output row once
    clip = lambda t, hi: np.clip(np.asarray(t), 0, hi - 1)
    uniq = (len(np.unique(np.concatenate([tabs[0], tabs[1]])))
            + len(np.unique(clip(tabs[2], H * wf.e_a)))
            + len(np.unique(np.concatenate(
                [clip(tabs[3], 2 * wf.e_a).ravel(),
                 clip(tabs[4], 2 * wf.e_a).ravel()]))))
    ka, ko = tabs[2].shape[1], tabs[4].shape[1]
    out_rows = s * (1 + ka + ko)
    small = sum(int(t.numel() * t.element_size()) for k, t in kw.items()
                if not k.endswith("src") and k != "g_new")
    nbytes = (uniq + s + out_rows) * res_p * 4 + small
    flops = commit_grid_flops(s, ka, ko, res_p)
    return kw, dict(B=s, ka=ka, ko=ko, Pf=res_p,
                    rows={"nodes": 4 * n, "rho_hist": H * wf.e_a,
                          "rho2": 2 * wf.e_a},
                    bytes=nbytes, flops=flops)


def compare_grid(kw, tol) -> float:
    """Kernel vs plain on the same inputs: the max abs error; raises
    unless every output is finite and within ``tol`` (atol = rtol)."""
    import torch
    from repro_torch.kernels.rfast_update.grid import (commit_grid,
                                                       commit_grid_plain)
    err = 0.0
    for g, w in zip(commit_grid(**kw), commit_grid_plain(**kw)):
        check(g.shape == w.shape and g.dtype == w.dtype, "output layout")
        check(bool(torch.isfinite(g).all()), "finite kernel output")
        check(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol),
              f"commit_grid within {tol}")
        if g.numel():
            err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def wave_case(w, rows: dict, p: int, seed: int):
    """``commit_grid``'s arguments at one wave (``w``, a ``wave_inputs``
    entry: its real lanes' row tables) over random sources with the row
    counts ``rows`` (nodes × 4, ρ history, ρ/ρ̃) at width ``p``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda r: torch.randn(r, p, generator=gen, device="cuda")
    nodes, hist, rho2 = (rnd(rows[k]) for k in ("nodes", "rho_hist",
                                                 "rho2"))
    B = w.agent.shape[0]
    kw = dict(zip(("idx_z", "idx_g", "idx_ri", "idx_rb", "idx_ro"), w.grid),
              a_self=w.a_self, mask=w.a_val, a_out=w.out_wt, z_src=nodes,
              g_new=rnd(B), go_src=nodes, ri_src=hist, rb_src=rho2,
              ro_src=rho2)
    return kw, dict(B=B, ka=w.grid[2].shape[1], ko=w.grid[4].shape[1], Pf=p,
                    rows=rows)


def fleet_wave_case(sp, seeds, n: int, p: int, seed: int):
    """:func:`wave_case` at a fleet's widest wave (from ``wave_inputs``
    of the flattened plan ``sp``), with the fleet's row counts."""
    from repro_torch.core.simulator import wave_inputs
    S = len(seeds)
    w = max(wave_inputs(sp.fleet, sp.ko, "cuda", seeds),
            key=lambda w: w.agent.shape[0])
    return wave_case(w, {"nodes": S * n * 4, "rho_hist": sp.H * S * sp.e_a,
                         "rho2": 2 * S * sp.e_a}, p, seed)


def epoch_plans(et, eval_every: int):
    """The plans ``run_epochs`` builds for the epoch trace ``et``: the
    trace-wide ``(H, kw, ka, ko, e_a)`` and, per epoch, its CommPlan,
    padded CommPlan, WavefrontPlan and chunk bounds (the engine's own
    planner)."""
    from repro_torch.core.simulator import _epoch_lane_plans, _epoch_shapes
    shapes = _epoch_shapes(et.epochs)
    H, kw, ka, ko, e_a = shapes
    return shapes, _epoch_lane_plans(et.epochs, eval_every, H=H, kw=kw,
                                     ka=ka, ko=ko, e_a=e_a)


def epoch_waves(et, eval_every: int) -> list[int]:
    """Per epoch, the waves with a real lane: the ``commit_grid``
    launches ``run_epochs(impl="kernel")`` makes for it."""
    return [int((wf.sizes > 0).sum())
            for *_, wf, _ in epoch_plans(et, eval_every)[1]]


def epoch_wave_case(et, eval_every: int, n: int, p: int, seed: int):
    """:func:`wave_case` at the widest wave of an epoch run (any epoch,
    each with its trace offset), with the trace-wide row counts."""
    from repro_torch.core.simulator import wave_inputs
    (H, _, _, ko, e_a), lane = epoch_plans(et, eval_every)
    w = max((wv for (*_, wf, _), ep in zip(lane, et.epochs)
             for wv in wave_inputs(wf, ko, "cuda", (0,), k0=ep.k0)),
            key=lambda w: w.agent.shape[0])
    return wave_case(w, {"nodes": n * 4, "rho_hist": H * e_a,
                         "rho2": 2 * e_a}, p, seed)


def npz_equal(a: Path, b: Path) -> bool:
    """Two checkpoint files hold the same members, bitwise (read one
    member at a time)."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x.files)


def ckpt_io(src: Path, like, dst: Path) -> dict:
    """Read ``src``'s latest checkpoint into ``like`` (card tensors) and
    write it to ``dst``: bytes of the file, and each direction's GB/s
    (device copies, npz coding and the fsync included)."""
    import torch
    from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
    step = latest_step(str(src))
    nbytes = (src / f"step_{step:010d}.npz").stat().st_size
    t0 = time.perf_counter()
    tree = load_checkpoint(str(src), like)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_checkpoint(str(dst), step, tree)
    write_s = time.perf_counter() - t0
    return dict(file_bytes=nbytes, read_s=read_s, write_s=write_s,
                read_gb_s=nbytes / read_s / 1e9,
                write_gb_s=nbytes / write_s / 1e9)


def time_fleet_wave(kw, case) -> dict:
    """One fleet wave's ``commit_grid`` against its plain twin (max abs
    error, raising past ``FP32_TOL``), both timed, beside its bound."""
    from repro_torch.kernels.rfast_update import grid
    err = compare_grid(kw, FP32_TOL)
    ms = cuda_ms(lambda: grid.commit_grid(**kw), reps=10)
    plain_ms = cuda_ms(lambda: grid.commit_grid_plain(**kw), reps=5)
    B, ka, ko, Pf = case["B"], case["ka"], case["ko"], case["Pf"]
    nbytes = grid.commit_grid_bytes(B, ka, ko, Pf, 4)
    flops = grid.commit_grid_flops(B, ka, ko, Pf)
    bound_ms, bound_by = bound(flops, nbytes, FP32_FLOP_PER_S)
    return dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                achieved_gb_s=nbytes / ms / 1e6, max_abs_err=err)


def device_busy(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` and measure the share of its
    span (a user annotation around it, the card synchronized inside) in
    which the card ran a kernel, a copy or a memset: the union of their
    intervals in the trace, how many kernels and copies it ran
    (``kernels``, ``copies``) and the ``TOP_KERNELS`` kernels with the
    most device time (name, launches, ms).  ``device_busy_share`` is
    None when the trace holds no device events."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_span"):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "traced_span"
            and e.get("cat") == "user_annotation"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    counts = {c: sum(e.get("cat") == c for e in events)
              for c in ("kernel", "gpu_memcpy")}
    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "kernel":
            row = by_name.setdefault(e.get("name", "")[:90], [0, 0.0])
            row[0] += 1
            row[1] += float(e["dur"]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    counts = dict(kernels=counts["kernel"], copies=counts["gpu_memcpy"],
                  top_kernels=[dict(name=k, launches=n, ms=ms)
                               for k, (n, ms) in top])
    if not span or not dev:
        return dict(device_busy_share=None, device_events=len(dev),
                    note="not measured: no span or no device events",
                    **counts)
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    busy, cur = 0.0, None
    for a, b in dev:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            busy += cur[1] - cur[0]
        cur = [a, b]
    if cur is not None:
        busy += cur[1] - cur[0]
    return dict(span_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / (t1 - t0), device_events=len(dev),
                **counts)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def step_percentiles(us: list[float]) -> dict:
    """n, p50, p99 and the largest of step times in µs (with n ≤ 100 the
    p99 is within one step of the largest)."""
    import numpy as np
    if not us:
        return dict(n=0, p50_us=None, p99_us=None, max_us=None)
    return dict(n=len(us), p50_us=float(np.percentile(us, 50)),
                p99_us=float(np.percentile(us, 99)), max_us=float(max(us)))


def decode_only_us(records: list[dict]) -> list[float]:
    """The host times of the engine steps that only decoded (no
    admission's prefill, no poll or flip)."""
    return [r["us"] for r in records
            if r["active"] and not r["admitted"] and not r["swap"]]


def decode_bound(cfg, params: dict, cache: dict, B: int) -> dict:
    """Least time of one decode step of B tokens, the larger of its bytes
    at the HBM rate and its fp32 operations (2 per weight per row it
    multiplies, 2 per cached cross k or v element): every parameter the
    decoder reads once (not the embedding table, the frontend's
    projection or the encoder, and of the cross attention only wq, bq and
    wo: its k and v are cached), the cache read once (``cache``: the
    ring's layers, and an enc-dec arch's ``cross_k`` / ``cross_v``), and
    of the table B rows, or the whole table when the head is tied (it is
    the head, read whole).  With MoE the step's
    dense capacity buffer (the reference's) multiplies every expert's
    weights by C = 8 slots a row: ``bound_ms`` counts all E experts, and
    ``routed_bound_ms`` beside it only the routed ones (at most B·top_k a
    layer) and the shared ones, what a step that skipped the unrouted
    experts would read."""
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.models.moe import _capacity
    embed = params["embed"]
    item = embed.element_size()
    read = {k: v for k, v in params.items()
            if k not in ("embed", "frontend_proj", "enc_layers", "enc_norm")}
    if "cross" in params["layers"]:
        read["layers"] = {**params["layers"], "cross": {
            k: v for k, v in params["layers"]["cross"].items()
            if k in ("wq", "bq", "wo")}}
    w = sum(t.numel() * t.element_size() for t in tree_leaves(read))
    tied = "lm_head" not in params
    table = embed.numel() * item if tied else B * embed.shape[1] * item
    kv = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    cross = sum(cache[k].numel() for k in ("cross_k", "cross_v")
                if k in cache)
    nbytes = w + table + kv
    flops = (2 * B * (w // item) + (2 * B * embed.numel() if tied else 0)
             + 2 * cross * (cfg.n_heads // max(1, cfg.n_kv_heads)))
    out = dict(param_bytes=w, table_bytes=table, tied_head=tied,
               cache_bytes=kv, cross_cache_bytes=cross * item)
    if cfg.moe_experts:
        E = cfg.moe_experts
        ex = sum(t.numel() * t.element_size() for t in tree_leaves(
            params["layers"]["mlp"]["experts"]))
        rows = B * _capacity(cfg, 1)          # the slots step's buffer
        flops += 2 * (rows - B) * (ex // item)
        used = min(E, B * cfg.moe_top_k)
        routed = nbytes - ex + ex * used // E
        out.update(expert_bytes=ex, experts_read=E,
                   routed_experts_at_most=used, routed_bytes=routed,
                   routed_bound_ms=routed / HBM_BYTES_PER_S * 1e3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops)
                * 1e3, bound_by="bytes" if t_bytes >= t_ops
                else "operations", **out)


def teacher_forced(cfg, params, toks, n_prompt: int, max_len: int,
                   frontend=None) -> dict:
    """``prefill_cache`` of ``toks[:, :n_prompt]`` (and ``frontend``: a
    prefix of patches, or an encoder's frames) and ``decode_step`` over
    the rest of ``toks`` (B, S) on the card, against one ``forward`` over
    all of ``toks`` and ``frontend``: the loop's logits (B, S − n_prompt +
    1, V), the forward's at the same positions, and each decode step's
    host time (the card synchronized)."""
    import torch
    from repro_torch.models import transformer as tt
    cache, lg = tt.prefill_cache(cfg, params, toks[:, :n_prompt], max_len,
                                 frontend=frontend)
    out, us = [lg[:, 0]], []
    for t in range(n_prompt, toks.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1])
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
        out.append(lg[:, 0])
    ref = tt.forward(cfg, params, toks, frontend)[0][:, n_prompt - 1:]
    return dict(loop=torch.stack(out, 1), ref=ref, step_us=us)


def beyond_rtol(got, want) -> float:
    """Largest |got − want| beyond ``SERVE_TF_TOL``·|want|: ≤ SERVE_TF_TOL
    is tests/test_serve.py's rtol = atol check."""
    return float(((got - want).abs() - SERVE_TF_TOL * want.abs()).max())


def tf_rel(tf: dict) -> float:
    """A teacher-forced loop's largest error over each step's largest
    |logit|."""
    return float(((tf["loop"] - tf["ref"]).abs().amax(-1)
                  / tf["ref"].abs().amax(-1)).max())


def busy_decode_us(eng, steps: int, prompt: int, rid0: int) -> list[float]:
    """Host µs of at least ``steps`` engine steps that only decode with
    every slot busy: rounds of B requests of ``prompt`` tokens, each
    generating to the end of ``max_len``, admitted together (the steps
    that admit are not counted).  ``prompt`` picks a bucket the engine
    has used, so no cache entry is added."""
    import numpy as np
    from repro_torch.serve import Request, Scheduler
    us, rid = [], rid0
    while len(us) < steps:
        sched = Scheduler([Request(
            rid=rid + i, prompt=np.arange(prompt, dtype=np.int32),
            gen=eng.max_len - prompt, arrive_s=0.0) for i in range(eng.B)])
        rid += eng.B
        n0 = len(eng.step_records)
        while len(sched) or eng.in_flight:
            eng.step(sched)
        us += decode_only_us(eng.step_records[n0:])
    return us


def scan_calls(fn) -> list[tuple]:
    """``fn()`` run with the model's scan recorded: the arguments of every
    ``ssm_scan`` call ``SelectiveScanFn`` makes in it, as that path lays
    them out (B and C column slices of one projection)."""
    from repro_torch.kernels.ssm_scan import ops
    calls, real = [], ops.ssm_scan

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    ops.ssm_scan = record
    try:
        fn()
    finally:
        ops.ssm_scan = real
    return calls


def phase_serve_rfast(name: str, smi: str) -> dict:
    """Phase 22: publish at full-width rfast-100m, serve from the first
    published step and hot-swap to the last.  Returns the publishing
    run's launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import (Request, Scheduler, ServeEngine,
                                   WeightStore, cache as serve_cache)
    cfg = get_config("rfast-100m")
    serve_root = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(serve_root, ignore_errors=True)
    pub, live = serve_root / "pub", serve_root / "live"
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    pres = train.main(PUBLISH_ARGS + ["--publish-dir", str(pub)])
    publish_wall = time.perf_counter() - t0
    publish_launches = dispatch.stats()["by_kernel"]
    published = pres["published"]
    emit("serve_publish", p=pres["p"], events=pres["events"],
         published=published, losses=pres["losses"], wall_s=publish_wall,
         launches=publish_launches,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(len(published) >= 2 and published[-1] == pres["events"],
          "train.py --publish-dir publishes at two chunk boundaries or more")
    check(publish_launches.get("commit_grid", 0) == pres["waves"],
          "one commit_grid launch per wave of the publishing run")
    torch.cuda.empty_cache()

    first, last = published[0], published[-1]
    template = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    trees = {k: load_checkpoint(str(pub), template, step=k)
             for k in (first, last)}
    del template
    save_checkpoint(str(live), first, trees[first])
    store = WeightStore(trees[first], step=first)
    serve_cache.clear()
    eng = ServeEngine(cfg, store, batch=SERVE_B, max_len=SERVE_MAX_LEN,
                      buckets=SERVE_BUCKETS, swap_mode="drain", poll_every=2,
                      ckpt_dir=str(live))
    rng = np.random.default_rng(0)
    lens = SERVE_FIRST_PROMPTS + rng.integers(
        1, 17, SERVE_REQUESTS - len(SERVE_FIRST_PROMPTS)).tolist()
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), gen=int(rng.integers(4, 13)), arrive_s=0.0)
        for i, n in enumerate(lens)]
    sched = Scheduler(reqs)
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    eng._t0 = t0
    eng.step(sched)
    in_flight = {r.rid for r in eng._slot_req if r is not None}
    check(len(in_flight) == SERVE_B, "the first step fills every slot")
    entries_before = serve_cache.stats()
    save_checkpoint(str(live), last, trees[last])
    while len(sched) or eng.in_flight or store.staged:
        eng.step(sched)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = dispatch.stats()["by_kernel"]
    entries_after = serve_cache.stats()
    buckets_used = sorted({eng.bucket_for(len(r.prompt)) for r in reqs})
    served_by = sorted({r.weights_step for r in reqs})
    all_steps = step_percentiles([r["us"] for r in eng.step_records])
    dec_steps = step_percentiles(decode_only_us(eng.step_records))
    check(all(r.done for r in reqs), "every request served")
    check(set(served_by) <= {first, last} and store.step == last
          and len(store.swaps) == 1 and store.loads == 1,
          "served by the first published step, then the last after one "
          f"live swap, loaded once: {served_by}, {store.swaps}, "
          f"{store.loads} loads")
    # every request teacher-forced through a B = 1 loop on the weights
    # that served it, against one forward
    worst, ties, mismatches, loop_us = 0.0, 0, [], []
    for r in reqs:
        toks = torch.from_numpy(np.concatenate(
            [r.prompt, np.asarray(r.tokens[:-1], np.int32)]))[None].cuda()
        tf = teacher_forced(cfg, trees[r.weights_step], toks, len(r.prompt),
                            SERVE_MAX_LEN)
        loop, ref = tf["loop"][0], tf["ref"][0]
        loop_us += tf["step_us"]
        worst = max(worst, float(((loop - ref).abs().amax(-1)
                                  / ref.abs().amax(-1)).max()))
        for i, tok in enumerate(r.tokens):
            if int(loop[i].argmax()) == tok:
                continue
            top = torch.topk(loop[i], 2).values
            if top[0] - top[1] <= SERVE_TOL * loop[i].abs().max():
                ties += 1
            else:
                mismatches.append((r.rid, i))
        del tf, loop, ref
    # decode-only steps with every slot busy, timed; then a few under the
    # profiler
    busy_us = busy_decode_us(eng, SERVE_TIMED_STEPS, len(reqs[0].prompt),
                             1000)
    bsched = Scheduler([Request(rid=100 + i, prompt=rng.integers(
        0, cfg.vocab, 4).astype(np.int32), gen=PROFILE_STEPS + 8,
        arrive_s=0.0) for i in range(SERVE_B)])
    for _ in range(3):
        eng.step(bsched)
    prof = device_busy(lambda: [eng.step(bsched)
                                for _ in range(PROFILE_STEPS)])
    rbound = decode_bound(cfg, store.params, eng._cache["layers"], SERVE_B)
    emit("serve_rfast", p=sum(t.numel() for t in tree_leaves(store.params)),
         batch=SERVE_B, max_len=SERVE_MAX_LEN, C=eng.C,
         buckets=list(SERVE_BUCKETS), requests=len(reqs),
         tokens=sum(len(r.tokens) for r in reqs), engine_steps=eng._step,
         wall_s=serve_wall, swaps=store.swaps, loads=store.loads,
         polls=store.polls, served_by=served_by,
         buckets_used=buckets_used, cache_before_swap=entries_before,
         cache_after=entries_after, step=all_steps, decode_step=dec_steps,
         decode_step_busy=step_percentiles(busy_us),
         b1_loop_decode_step=step_percentiles(loop_us),
         launches=serve_launches, max_rel_err=worst, tol=SERVE_TOL,
         argmax_ties=ties, argmax_mismatches=mismatches,
         profiled_steps=PROFILE_STEPS,
         kernels_per_decode_step=prof["kernels"] / PROFILE_STEPS,
         copies_per_decode_step=prof["copies"] / PROFILE_STEPS,
         profile=prof, **rbound,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(all(r.weights_step == first for r in reqs if r.rid in in_flight),
          "drain: the requests in flight at the re-publish finish on the "
          "old weights")
    check(entries_after["entries"] == 1 + len(buckets_used)
          and entries_after["misses"] == entries_before["misses"],
          "1 decode + one prefill entry per bucket used, none added across "
          "the swap")
    check(worst <= SERVE_TOL and not mismatches,
          f"B = 1 loop vs forward within {SERVE_TOL}; every engine token is "
          f"its argmax or a tie: {worst}, {mismatches}")
    check(not serve_launches and prof["kernels"] > 0,
          "the attention path launches no kernel of the port")
    del eng, store, trees, bsched
    shutil.rmtree(serve_root)
    torch.cuda.empty_cache()
    return publish_launches


def phase_serve_llama(name: str, smi: str) -> None:
    """Phase 23: llama3-8b at full width and depth through
    ``launch/serve.main``, then an ``immediate`` engine timed with every
    slot busy before and after a live swap."""
    import numpy as np
    import torch
    from repro_torch.core.paramvec import tree_leaves, tree_map
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import serve
    from repro_torch.serve import (DEFAULT_BUCKETS, Request, Scheduler,
                                   cache as serve_cache)
    serve_cache.clear()
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    lres = serve.main(LLAMA_SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.stats()["by_kernel"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    reqs = lres["report"]["requests"]
    buckets = sorted({next(b for b in DEFAULT_BUCKETS if len(r.prompt) <= b)
                      for r in reqs})
    entries = serve_cache.stats()
    dec = step_percentiles(decode_only_us(lres["report"]["steps"]))
    del lres
    torch.cuda.empty_cache()
    # an immediate engine of the same arguments: decode-only steps with
    # every slot busy, one live swap (a 0.9x copy offered with every slot
    # busy), the same busy steps again
    sargs = serve.parse_args(LLAMA_SERVE_ARGS + ["--swap-mode", "immediate"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serve.make_engine(sargs)
    init_s = time.perf_counter() - t0
    p = sum(t.numel() for t in tree_leaves(eng.store.params))
    plen = len(reqs[0].prompt)
    before_us = busy_decode_us(eng, SERVE_TIMED_STEPS, plen, 1000)
    sreqs = serve.make_requests(sargs, eng.cfg.vocab)
    sched = Scheduler(sreqs)
    eng._t0 = time.perf_counter()
    while eng.in_flight < eng.B and len(sched):
        eng.step(sched)
    in_flight = {r.rid for r in eng._slot_req if r is not None}
    eng.store.offer(tree_map(lambda t: t * 0.9, eng.store.params), step=1,
                    published_at=time.time())
    offer_peak = torch.cuda.max_memory_allocated() / 1e9
    while len(sched) or eng.in_flight or eng.store.staged:
        eng.step(sched)
    torch.cuda.synchronize()
    swap_wall = time.perf_counter() - eng._t0
    after_us = busy_decode_us(eng, SERVE_TIMED_STEPS, plen, 2000)
    swap_entries = serve_cache.stats()
    step_bound = decode_bound(eng.cfg, eng.store.params,
                              eng._cache["layers"], eng.B)
    busy = Scheduler([Request(rid=100 + i, prompt=np.arange(
        4, dtype=np.int32), gen=PROFILE_STEPS + 8, arrive_s=0.0)
        for i in range(eng.B)])
    for _ in range(3):
        eng.step(busy)
    prof = device_busy(lambda: [eng.step(busy)
                                for _ in range(PROFILE_STEPS)])
    emit("serve_llama", p=p, param_gb=p * 4 / 1e9, batch=eng.B, C=eng.C,
         requests=len(reqs), served=sum(r.done for r in reqs),
         tokens=sum(len(r.tokens) for r in reqs), wall_s=wall,
         buckets_used=buckets, cache=entries, decode_step=dec,
         launches=launches, max_memory_allocated_gb=peak,
         decode_step_busy=step_percentiles(before_us + after_us),
         swap=dict(init_s=init_s, wall_s=swap_wall, swaps=eng.store.swaps,
                   in_flight=sorted(in_flight),
                   served_by=sorted({r.weights_step for r in sreqs}),
                   cache=swap_entries,
                   decode_step_busy_before=step_percentiles(before_us),
                   decode_step_busy_after=step_percentiles(after_us),
                   peak_gb_at_offer=offer_peak,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9),
         kernels_per_decode_step=prof["kernels"] / PROFILE_STEPS,
         profile=prof, **step_bound, device=name, nvidia_smi=smi)
    check(p == 8_030_261_248, f"llama3-8b has 8,030,261,248 parameters: {p}")
    check(all(r.done for r in reqs) and len(reqs) == 16,
          "serve.main serves every request")
    check(entries["entries"] == 1 + len(buckets),
          "1 decode + one prefill entry per bucket used")
    check(all(r.done for r in sreqs) and len(eng.store.swaps) == 1
          and in_flight and all(
              r.weights_step == 1 for r in sreqs if r.rid in in_flight),
          "an immediate swap lands with every slot busy; the in-flight "
          "requests finish on the new weights")
    check(swap_entries["misses"] == entries["misses"],
          "no cache entry added by the second engine or across the swap")
    del eng, sreqs, sched, reqs, busy
    torch.cuda.empty_cache()


def phase_serve_hymba(name: str, smi: str) -> dict:
    """Phase 24: hybrid decode with the scan kernel at full-width
    hymba-1.5b.  Returns ``ssm_scan``'s launches by ``prefill_cache`` and
    by ``forward``, and its errors against ``ssm_scan_plain`` on the
    inputs those calls gave it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.kernels.ssm_scan import kernel as scan_k
    from repro_torch.models import transformer as tt
    from repro_torch.models.transformer import init_params
    cfg = get_config("hymba-1.5b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    p = sum(t.numel() for t in tree_leaves(params))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (HYMBA_SERVE_B, HYMBA_PROMPT + HYMBA_DECODE))).cuda()
    hmax = HYMBA_PROMPT + HYMBA_DECODE
    prefill = lambda: tt.prefill_cache(cfg, params, toks[:, :HYMBA_PROMPT],
                                       hmax)

    def forward():
        with torch.no_grad():
            tt.forward(cfg, params, toks)

    dispatch.clear()
    cache, _ = prefill()
    torch.cuda.synchronize()
    prefill_launches = dispatch.stats()["by_kernel"]
    dispatch.clear()
    tt.decode_step(cfg, params, cache, toks[:, HYMBA_PROMPT:
                                            HYMBA_PROMPT + 1])
    torch.cuda.synchronize()
    decode_launches = dispatch.stats()["by_kernel"]
    del cache
    dispatch.clear()
    forward()
    torch.cuda.synchronize()
    forward_launches = dispatch.stats()["by_kernel"]
    # the kernel against its plain twin on every layer's inputs of both
    # paths (the path's own call, then layer 0 unsplit and split with the
    # checkpoints); these launches are not counted above
    err_by_shape = {}
    for what, run in (("prefill_cache", prefill), ("forward", forward)):
        calls = scan_calls(run)
        check(len(calls) == cfg.n_layers, f"{what}: one scan a layer")
        errs = []
        for li, args in enumerate(calls):
            want = scan_k.ssm_scan_plain(*args)
            errs.append(max(held(g, w, SCAN_FP32_TOL,
                                 f"ssm_scan, hymba {what} layer {li} {n}")
                            for g, w, n in zip(scan_k.ssm_scan(*args), want,
                                               ("y", "h_last"))))
        errs.append(compare_scan(calls[0], SCAN_FP32_TOL,
                                 f"ssm_scan, hymba {what} layer 0"))
        Bsz, S, di = calls[0][0].shape
        err_by_shape[f"hymba serving {what} ({Bsz}, {S}, {di}, "
                     f"{calls[0][2].shape[1]})"] = max(errs)
        del calls
    tf = teacher_forced(cfg, params, toks, HYMBA_PROMPT, hmax)
    viol = float(((tf["loop"] - tf["ref"]).abs()
                  - SERVE_TF_TOL * tf["ref"].abs()).max())
    rel = float(((tf["loop"] - tf["ref"]).abs().amax(-1)
                 / tf["ref"].abs().amax(-1)).max())
    cache, _ = prefill()
    step_bound = decode_bound(cfg, params, cache["layers"], HYMBA_SERVE_B)
    prof = device_busy(lambda: [tt.decode_step(
        cfg, params, cache, toks[:, t:t + 1]) for t in range(
            HYMBA_PROMPT, HYMBA_PROMPT + PROFILE_STEPS)])
    del cache
    wall = time.perf_counter() - t0
    emit("serve_hymba", p=p, layers=cfg.n_layers, batch=HYMBA_SERVE_B,
         prompt=HYMBA_PROMPT, decode_steps=len(tf["step_us"]),
         C=tt.cache_capacity(cfg, hmax), wall_s=wall,
         launches=dict(prefill_cache=prefill_launches,
                       decode_step=decode_launches,
                       forward=forward_launches),
         ssm_scan_max_abs_err=err_by_shape, ssm_scan_tol=SCAN_FP32_TOL,
         max_abs_err_beyond_rtol=viol, max_rel_err=rel, tol=SERVE_TF_TOL,
         decode_step=step_percentiles(tf["step_us"]),
         kernels_per_decode_step=prof["kernels"] / PROFILE_STEPS,
         profile=prof, **step_bound,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(viol <= SERVE_TF_TOL, f"prefill_cache + decode_step vs one forward "
          f"within rtol = atol = {SERVE_TF_TOL}")
    check(prefill_launches == {"ssm_scan": cfg.n_layers}
          and forward_launches == {"ssm_scan": cfg.n_layers}
          and not decode_launches,
          "ssm_scan: one launch per layer in prefill_cache and in forward, "
          "none in a decode step")
    del params, toks, tf
    torch.cuda.empty_cache()
    return dict(prefill_cache=prefill_launches["ssm_scan"],
                forward=forward_launches["ssm_scan"],
                max_abs_err=max(err_by_shape.values()),
                err_by_shape=err_by_shape)


def zoo_serve(arch: str, layers, name: str, smi: str) -> None:
    """Phase 25 for one arch: its weights drawn on the card at full width
    (``layers`` of them, or all), ``prefill_cache`` + ``decode_step``
    against one teacher-forced ``forward`` (the MoE capacity lifted as
    tests/test_serve.py lifts it), a ``ServeEngine`` run, busy decode-only
    steps, a profiled window and the step's bytes bound."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.models import transformer as tt
    from repro_torch.serve import (Request, Scheduler, ServeEngine,
                                   WeightStore, cache as serve_cache)
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers) if layers else full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tt.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    tf_cfg = (dataclasses.replace(cfg, capacity_factor=ZOO_TF_CAPACITY)
              if cfg.moe_experts else cfg)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ZOO_TF_B, ZOO_TF_S))).cuda()
    dispatch.clear()
    tf = teacher_forced(tf_cfg, params, toks, ZOO_TF_PROMPT, ZOO_TF_S)
    viol, rel = beyond_rtol(tf["loop"], tf["ref"]), tf_rel(tf)
    tf_us = tf["step_us"]
    del tf
    serve_cache.clear()
    eng = ServeEngine(cfg, WeightStore(params), batch=SERVE_B,
                      max_len=SERVE_MAX_LEN, buckets=SERVE_BUCKETS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), gen=ZOO_GEN, arrive_s=0.0)
        for i, n in enumerate(ZOO_PROMPTS)]
    t0 = time.perf_counter()
    report = eng.run(reqs)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    launches = dispatch.stats()["by_kernel"]
    entries = serve_cache.stats()
    buckets_used = sorted({eng.bucket_for(len(r.prompt)) for r in reqs})
    busy_us = busy_decode_us(eng, ZOO_BUSY_STEPS, 4, 1000)
    busy = Scheduler([Request(rid=100 + i, prompt=np.arange(
        4, dtype=np.int32), gen=PROFILE_STEPS + 8, arrive_s=0.0)
        for i in range(eng.B)])
    for _ in range(3):
        eng.step(busy)
    prof = device_busy(lambda: [eng.step(busy)
                                for _ in range(PROFILE_STEPS)])
    step_bound = decode_bound(cfg, params, eng._cache["layers"], eng.B)
    emit("zoo_serve", arch=arch, layers=cfg.n_layers,
         of_layers=full.n_layers,
         cut=None if layers is None else f"depth: {layers} of "
         f"{full.n_layers} layers", p=p, param_gb=p * 4 / 1e9,
         init_s=init_s, tf_batch=ZOO_TF_B, tf_seq=ZOO_TF_S,
         tf_prompt=ZOO_TF_PROMPT, tf_capacity_factor=tf_cfg.capacity_factor,
         max_abs_err_beyond_rtol=viol, max_rel_err=rel, tol=SERVE_TF_TOL,
         tf_decode_step=step_percentiles(tf_us), batch=eng.B, C=eng.C,
         buckets=list(SERVE_BUCKETS), requests=len(reqs),
         served=sum(r.done for r in reqs),
         tokens=sum(len(r.tokens) for r in reqs), serve_wall_s=serve_wall,
         buckets_used=buckets_used, cache=entries,
         decode_step=step_percentiles(decode_only_us(report["steps"])),
         decode_step_busy=step_percentiles(busy_us), launches=launches,
         kernels_per_decode_step=prof["kernels"] / PROFILE_STEPS,
         profile=prof, **step_bound,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(p == ZOO_PARAMS[arch], f"{arch}: {ZOO_PARAMS[arch]:,} parameters "
          f"at {cfg.n_layers} layers: {p:,}")
    check(viol <= SERVE_TF_TOL, f"{arch}: prefill_cache + decode_step vs "
          f"one forward within rtol = atol = {SERVE_TF_TOL}")
    check(all(r.done for r in reqs) and len(reqs) >= 8,
          f"{arch}: the engine serves every request")
    check(entries["entries"] == 1 + len(buckets_used) == 1 + len(
        SERVE_BUCKETS), f"{arch}: 1 decode + one prefill entry per bucket "
          f"used: {entries}")
    check(len(busy_us) >= ZOO_BUSY_STEPS,
          f"{arch}: {ZOO_BUSY_STEPS} busy decode-only steps timed")
    check(not launches and prof["kernels"] > 0,
          f"{arch}: the attention path launches no kernel of the port")
    del eng, params, report, busy, toks
    torch.cuda.empty_cache()


def phase_zoo_serve(name: str, smi: str) -> None:
    """Phase 25: every zoo arch served at full width."""
    for arch, layers in ZOO_SERVE:
        zoo_serve(arch, layers, name, smi)


def ckpt_rows(path, field: str):
    """The ``field`` leaves of a checkpoint file (``.x``, or the ``.x/``
    subtree of a model tree) flattened into one float64 vector."""
    import numpy as np
    with np.load(path) as f:
        keys = sorted(k for k in f.files
                      if k == field or k.startswith(field + "/"))
        return np.concatenate([f[k].astype(np.float64).ravel()
                               for k in keys])


def zoo_train_pair(tag: str, extra: list, arch: str, root: Path, name: str,
                   smi: str) -> int:
    """One reduced zoo arch through ``launch.train`` (``ZOO_TRAIN_ARGS`` +
    ``extra``), ``impl kernel`` against ``impl plain``: their last
    checkpoints' x and z within phase 5's tolerance, ``commit_grid``
    launched once per round or wave.  Returns the kernel run's launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import train
    runs = {}
    for impl in ("kernel", "plain"):
        d = root / f"{tag}-{arch}-{impl}"
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        res = train.main(["--arch", arch] + ZOO_TRAIN_ARGS + extra
                         + ["--impl", impl, "--ckpt", str(d)])
        torch.cuda.synchronize()
        last = sorted(d.glob("step_*.npz"))[-1]
        runs[impl] = dict(
            res=res, wall_s=time.perf_counter() - t0,
            launches=dispatch.stats()["by_kernel"],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            x=ckpt_rows(last, ".x"), z=ckpt_rows(last, ".z"))
        shutil.rmtree(d)
        torch.cuda.empty_cache()
    k, pl = runs["kernel"], runs["plain"]
    rel = {f: float(np.linalg.norm(k[f] - pl[f]) / np.linalg.norm(pl[f]))
           for f in ("x", "z")}
    steps = k["res"]["rounds"] if tag == "sync" else k["res"]["waves"]
    emit("zoo_train", arch=arch, regime=tag, args=extra, reduced=True,
         p=k["res"]["p"], rounds=k["res"].get("rounds"),
         events=k["res"].get("events"), waves=k["res"].get("waves"),
         losses={i: r["res"]["losses"] for i, r in runs.items()},
         wall_s={i: r["wall_s"] for i, r in runs.items()},
         max_memory_allocated_gb={i: r["peak_gb"] for i, r in runs.items()},
         launches={i: r["launches"] for i, r in runs.items()},
         x_rel=rel["x"], z_rel=rel["z"], tol=BACKEND_TOL,
         lemma3_rel=k["res"]["mass_rel"], device=name, nvidia_smi=smi)
    check(all(math.isfinite(v) for r in runs.values()
              for v in r["res"]["losses"]), f"zoo {tag} {arch}: finite losses")
    check(max(rel.values()) <= BACKEND_TOL,
          f"zoo {tag} {arch}: kernel and plain agree to {BACKEND_TOL}: {rel}")
    check(steps > 0 and k["launches"] == {"commit_grid": steps}
          and not pl["launches"],
          f"zoo {tag} {arch}: one commit_grid launch per "
          f"{'round' if tag == 'sync' else 'wave'} (plain none): "
          f"{k['launches']}, {pl['launches']}")
    return steps


def phase_zoo_train(name: str, smi: str) -> dict:
    """Phase 26: the zoo archs at ``--reduced`` through ``launch.train``,
    ``impl kernel`` against ``impl plain`` (``zoo_train_pair``), then
    full-width olmo-1b cut to ``OLMO_TRAIN_LAYERS`` layers in sync
    rounds.  Returns the runs' ``commit_grid`` launches by path."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import train
    root = ROOT / "build" / "chip_smoke_zoo"
    shutil.rmtree(root, ignore_errors=True)
    paths = {}
    for tag, extra, archs in ZOO_TRAIN_RUNS:
        for arch in archs:
            paths[f"zoo_{tag}_{arch}"] = zoo_train_pair(tag, extra, arch,
                                                        root, name, smi)
    shutil.rmtree(root, ignore_errors=True)
    # olmo-1b at full width, OLMO_TRAIN_LAYERS of its 16 layers, sync
    cfg_o = dataclasses.replace(get_config("olmo-1b"),
                                n_layers=OLMO_TRAIN_LAYERS)
    args = train.parse_args(OLMO_TRAIN_ARGS)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    ores = train._train_sync(args, cfg_o, torch.device("cuda"))
    torch.cuda.synchronize()
    owall = time.perf_counter() - t0
    olaunches = dispatch.stats()["by_kernel"]
    emit("zoo_train_olmo", layers=OLMO_TRAIN_LAYERS, of_layers=16,
         cut=f"depth: {OLMO_TRAIN_LAYERS} of 16 layers", p=ores["p"],
         rounds=ores["rounds"], losses=ores["losses"], wall_s=owall,
         state_gb=ores["state_bytes"] / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         memory_gb={k: {m: b / 1e9 for m, b in v.items()}
                    for k, v in ores["memory"].items()},
         resident_before_gb=resident / 1e9, launches=olaunches,
         lemma3_rel=ores["mass_rel"], device=name, nvidia_smi=smi)
    check(ores["p"] == OLMO_TRAIN_P, f"olmo-1b at {OLMO_TRAIN_LAYERS} "
          f"layers has {OLMO_TRAIN_P:,} parameters: {ores['p']:,}")
    check(all(math.isfinite(v) for v in ores["losses"]),
          "olmo-1b sync: finite losses")
    check(olaunches == {"commit_grid": ores["rounds"]},
          f"olmo-1b sync: one commit_grid launch per round: {olaunches}")
    check(ores["mass_rel"] <= 1e-4, "olmo-1b sync: Lemma-3 <= 1e-4")
    paths["zoo_sync_olmo-1b_full_width"] = ores["rounds"]
    torch.cuda.empty_cache()
    return paths


def frontend_rows(cfg, batch: int, rng):
    """Stub frame or patch embeddings (batch, frontend_seq, frontend_dim)
    drawn with numpy, on the card."""
    import numpy as np
    import torch
    return torch.from_numpy(rng.standard_normal(
        (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)).cuda()


def timed_decode(cfg, params, cache, rng) -> dict:
    """``FRONT_STEPS`` ``decode_step`` calls after 3 untimed ones, each
    timed on the host with the card synchronized, then ``PROFILE_STEPS``
    steps under ``device_busy``: their percentiles, kernels and device
    ms a step, the busy share."""
    import torch
    from repro_torch.models import transformer as tt
    B = cache["layers"]["attn"]["k"].shape[1]
    tok = lambda: torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).cuda()
    for _ in range(3):
        tt.decode_step(cfg, params, cache, tok())
    us = []
    for _ in range(FRONT_STEPS):
        t = tok()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.decode_step(cfg, params, cache, t)
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
    t = tok()
    prof = device_busy(lambda: [tt.decode_step(cfg, params, cache, t)
                                for _ in range(PROFILE_STEPS)])
    busy_ms = prof.get("device_busy_ms")
    return dict(decode_step=step_percentiles(us),
                kernels_per_decode_step=prof["kernels"] / PROFILE_STEPS,
                device_ms_per_step=None if busy_ms is None
                else busy_ms / PROFILE_STEPS, profile=prof)


def whisper_train(name: str, smi: str) -> int:
    """Phase 27's training: full-width whisper-large-v3 cut to
    ``WHISPER_TRAIN_LAYERS`` decoder and encoder layers, in lossy sync
    rounds through the port's ``make_rfast_round`` with ``sync_grad_fn``
    and batches of (toks, labels, frames): ``impl kernel`` against
    ``impl plain`` from one start.  Returns the kernel run's rounds."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import make_ravel_spec, ravel
    from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                          make_rfast_round,
                                          runtime_tracked_mass)
    from repro_torch.core.topology import get_topology
    from repro_torch.data.pipeline import LMShardConfig
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import train
    from repro_torch.models import transformer as tt
    from repro_torch.optim.schedules import warmup_cosine
    full = get_config("whisper-large-v3")
    cfg = dataclasses.replace(full, n_layers=WHISPER_TRAIN_LAYERS,
                              n_enc_layers=WHISPER_TRAIN_LAYERS)
    n, rounds, bsz = WHISPER_TRAIN_NODES, WHISPER_TRAIN_ROUNDS, \
        WHISPER_TRAIN_BATCH
    params0 = tt.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
    rspec = make_ravel_spec(params0)
    x0 = ravel(rspec, params0)
    del params0
    spec = edge_arrays(get_topology("binary_tree", n))
    shard = LMShardConfig(vocab=cfg.vocab, batch_per_node=bsz,
                          seq_len=WHISPER_TRAIN_SEQ, n_nodes=n, seed=0)
    frames = {}

    def batches(step):
        toks, labels = train.sync_batches(shard, step, "cuda")
        if step not in frames:
            frames[step] = torch.from_numpy(np.random.default_rng(
                (shard.seed, step)).standard_normal(
                (n, bsz, cfg.frontend_seq, cfg.frontend_dim)).astype(
                np.float32)).cuda()
        return toks, labels, frames[step]

    mrng = np.random.default_rng(1)
    masks = [torch.from_numpy((mrng.uniform(size=spec.e_pad)
                               >= WHISPER_TRAIN_LOSS).astype(np.float32))
             .cuda() for _ in range(rounds)]
    grad_fn = train.sync_grad_fn(cfg, rspec)
    gamma = warmup_cosine(3e-3, warmup=max(1, rounds // 20), total=rounds)
    runs = {}
    for impl in ("kernel", "plain"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        st = init_node_state(spec, x0, grad_fn, batches(0), robust=True)
        rf = make_rfast_round(spec, grad_fn, gamma=gamma, robust=True,
                              impl=impl, donate=True)
        losses = []
        for step in range(rounds):
            st, met = rf(st, batches(step), None, masks[step])
            losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        g_sum = st.g_prev.sum(0)
        runs[impl] = dict(
            wall_s=time.perf_counter() - t0, losses=losses,
            launches=dispatch.stats()["by_kernel"],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            state_gb=sum(t.numel() * t.element_size() for t in st[1:]
                         if t is not None) / 1e9,
            lemma3_rel=float(torch.linalg.vector_norm(
                runtime_tracked_mass(st) - g_sum)
                / torch.linalg.vector_norm(g_sum)),
            x=st.x, z=st.z)
        del st, rf, met, g_sum
    k, pl = runs["kernel"], runs["plain"]
    rel = {f: float(torch.linalg.vector_norm(k[f] - pl[f])
                    / torch.linalg.vector_norm(pl[f])) for f in ("x", "z")}
    keep = ("wall_s", "losses", "launches", "peak_gb", "state_gb",
            "lemma3_rel")
    emit("whisper_train", layers=WHISPER_TRAIN_LAYERS,
         enc_layers=WHISPER_TRAIN_LAYERS, of_layers=full.n_layers,
         cut=f"depth: {WHISPER_TRAIN_LAYERS} of {full.n_layers} decoder "
         f"and encoder layers; widths and the {cfg.frontend_seq} frames "
         "as published", p=int(x0.numel()), nodes=n, rounds=rounds,
         batch_per_node=bsz, seq=WHISPER_TRAIN_SEQ,
         loss_prob=WHISPER_TRAIN_LOSS,
         runs={i: {f: r[f] for f in keep} for i, r in runs.items()},
         x_rel=rel["x"], z_rel=rel["z"], tol=BACKEND_TOL, device=name,
         nvidia_smi=smi)
    check(x0.numel() == WHISPER_TRAIN_P, f"whisper-large-v3 at "
          f"{WHISPER_TRAIN_LAYERS} + {WHISPER_TRAIN_LAYERS} layers has "
          f"{WHISPER_TRAIN_P:,} parameters: {x0.numel():,}")
    check(all(math.isfinite(v) for r in runs.values() for v in r["losses"]),
          "whisper sync: finite losses")
    check(max(rel.values()) <= BACKEND_TOL,
          f"whisper sync: kernel and plain agree to {BACKEND_TOL}: {rel}")
    check(k["launches"] == {"commit_grid": rounds} and not pl["launches"],
          f"whisper sync: one commit_grid launch per round (plain none): "
          f"{k['launches']}, {pl['launches']}")
    check(k["lemma3_rel"] <= 1e-4, "whisper sync: Lemma-3 <= 1e-4")
    del runs, k, pl, frames, masks, x0
    torch.cuda.empty_cache()
    return rounds


def phase_whisper(name: str, smi: str) -> dict:
    """Phase 27: whisper-large-v3 at full width and depth (the encoder
    over 1500 frames, cross attention, absolute positions, the GELU MLP
    with biases), then ``whisper_train``.  Returns the ``commit_grid``
    launches by path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.models import transformer as tt
    cfg = get_config("whisper-large-v3")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tt.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ZOO_TF_B, ZOO_TF_S))).cuda()
    frames = frontend_rows(cfg, ZOO_TF_B, rng)
    dispatch.clear()
    tf = teacher_forced(cfg, params, toks, ZOO_TF_PROMPT, ZOO_TF_S, frames)
    viol, rel = beyond_rtol(tf["loop"], tf["ref"]), tf_rel(tf)
    del tf
    # token-wise prefill over init_cache's cross caches vs prefill_cache
    n = WHISPER_TOKENWISE
    c_ref, l_ref = tt.prefill(cfg, params, tt.init_cache(
        cfg, params, ZOO_TF_B, ZOO_TF_S, frontend=frames), toks[:, :n])
    c_new, last = tt.prefill_cache(cfg, params, toks[:, :n], ZOO_TF_S,
                                   frontend=frames)
    cross_rel = max(float((c_new[k] - c_ref[k]).abs().max()
                          / c_ref[k].abs().max())
                    for k in ("cross_k", "cross_v"))
    l1, _ = tt.decode_step(cfg, params, c_ref, toks[:, n:n + 1])
    l2, _ = tt.decode_step(cfg, params, c_new, toks[:, n:n + 1])
    tw_viol = max(beyond_rtol(last[:, 0], l_ref[:, -1]),
                  beyond_rtol(l2, l1))
    del c_ref, c_new, l_ref, last, l1, l2, frames
    torch.cuda.empty_cache()
    # the encoder's time, then FRONT_STEPS decode steps, at FRONT_B
    frames = frontend_rows(cfg, FRONT_B, rng)
    enc_ms = cuda_ms(lambda: tt.init_cache(cfg, params, FRONT_B,
                                           WHISPER_MAX_LEN, frontend=frames),
                     reps=ENCODER_REPS, warmup=1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (FRONT_B, FRONT_PROMPT))).cuda()
    cache, _ = tt.prefill_cache(cfg, params, prompt, WHISPER_MAX_LEN,
                                frontend=frames)
    dec = timed_decode(cfg, params, cache, rng)
    launches = dispatch.stats()["by_kernel"]
    step_bound = decode_bound(cfg, params, {
        k: cache[k] for k in ("layers", "cross_k", "cross_v")}, FRONT_B)
    emit("whisper_serve", arch=cfg.name, layers=cfg.n_layers,
         enc_layers=cfg.n_enc_layers, frames=cfg.frontend_seq, p=p,
         param_gb=p * 4 / 1e9, init_s=init_s, tf_batch=ZOO_TF_B,
         tf_seq=ZOO_TF_S, tf_prompt=ZOO_TF_PROMPT,
         max_abs_err_beyond_rtol=viol, max_rel_err=rel, tol=SERVE_TF_TOL,
         tokenwise_prompt=n, tokenwise_beyond_rtol=tw_viol,
         cross_cache_rel=cross_rel, batch=FRONT_B, max_len=WHISPER_MAX_LEN,
         encoder_ms=enc_ms, **dec, launches=launches, **step_bound,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(p == WHISPER_PARAMS, f"whisper-large-v3: {WHISPER_PARAMS:,} "
          f"parameters: {p:,}")
    check(viol <= SERVE_TF_TOL, f"whisper: prefill_cache + decode_step vs "
          f"one forward within rtol = atol = {SERVE_TF_TOL}")
    check(tw_viol <= SERVE_TF_TOL and cross_rel <= SERVE_TOL,
          "whisper: init_cache + token-wise prefill vs prefill_cache, and "
          "a decode step from each")
    check(dec["decode_step"]["n"] >= ZOO_BUSY_STEPS,
          f"whisper: {ZOO_BUSY_STEPS} decode steps timed")
    check(not launches and dec["profile"]["kernels"] > 0,
          "whisper: the serving path launches no kernel of the port")
    del params, cache, frames, prompt, toks
    torch.cuda.empty_cache()
    return {"zoo_sync_whisper-large-v3_full_width": whisper_train(name, smi)}


def phase_pixtral(name: str, smi: str) -> dict:
    """Phase 28: pixtral-12b at full width and depth, its patches
    prepended to the text, then at ``--reduced`` through
    ``zoo_train_pair``.  Returns the ``commit_grid`` launches by path."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import tree_leaves
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.models import transformer as tt
    cfg = get_config("pixtral-12b")
    F = cfg.frontend_seq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tt.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ZOO_TF_B, ZOO_TF_S))).cuda()
    dispatch.clear()
    tf = teacher_forced(cfg, params, toks, ZOO_TF_PROMPT, F + ZOO_TF_S,
                        frontend_rows(cfg, ZOO_TF_B, rng))
    viol, rel = beyond_rtol(tf["loop"], tf["ref"]), tf_rel(tf)
    del tf
    torch.cuda.empty_cache()
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (FRONT_B, FRONT_PROMPT))).cuda()
    patches = frontend_rows(cfg, FRONT_B, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, _ = tt.prefill_cache(cfg, params, prompt, PIXTRAL_MAX_LEN,
                                frontend=patches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    idx0 = int(cache["idx"])
    dec = timed_decode(cfg, params, cache, rng)
    launches = dispatch.stats()["by_kernel"]
    step_bound = decode_bound(cfg, params, cache["layers"], FRONT_B)
    emit("pixtral_serve", arch=cfg.name, layers=cfg.n_layers, patches=F,
         head_dim=cfg.hd, p=p, param_gb=p * 4 / 1e9, init_s=init_s,
         resident_before_gb=resident / 1e9, tf_batch=ZOO_TF_B,
         tf_seq=ZOO_TF_S, tf_prompt=ZOO_TF_PROMPT,
         max_abs_err_beyond_rtol=viol, max_rel_err=rel, tol=SERVE_TF_TOL,
         batch=FRONT_B, max_len=PIXTRAL_MAX_LEN, prompt=FRONT_PROMPT,
         prefill_ms=prefill_ms, idx_after_prefill=idx0, **dec,
         launches=launches, **step_bound,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(p == PIXTRAL_PARAMS, f"pixtral-12b: {PIXTRAL_PARAMS:,} "
          f"parameters: {p:,}")
    check(viol <= SERVE_TF_TOL, f"pixtral: prefill_cache with the patches "
          f"+ decode_step vs one forward within rtol = atol = "
          f"{SERVE_TF_TOL}")
    check(idx0 == F + FRONT_PROMPT, "pixtral: the patch rows are prefilled "
          "before the prompt")
    check(dec["decode_step"]["n"] >= ZOO_BUSY_STEPS,
          f"pixtral: {ZOO_BUSY_STEPS} decode steps timed")
    check(not launches and dec["profile"]["kernels"] > 0,
          "pixtral: the serving path launches no kernel of the port")
    del params, cache, patches, prompt, toks
    torch.cuda.empty_cache()
    root = ROOT / "build" / "chip_smoke_zoo"
    shutil.rmtree(root, ignore_errors=True)
    steps = zoo_train_pair("sync", ["--loss-prob", "0.2"], "pixtral-12b",
                           root, name, smi)
    shutil.rmtree(root, ignore_errors=True)
    return {"zoo_sync_pixtral-12b": steps}


# --------------------------------------------------------------------- #
# flash attention cases
# --------------------------------------------------------------------- #
def _sync_free(fn) -> None:
    """Run ``fn()`` with CUDA's sync debug mode raising on any host
    synchronisation (RF201 on the card)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_analysis(name: str, smi: str, train_res: dict,
                   train_launches: int) -> dict:
    """Phase 29: the static analysis on the card (``repro_torch.analysis``).

    (a) phase 4's run with ``--verify-plans``: the same losses and
    ``commit_grid`` launches, with the lint's host ms over the same
    plans (``sweep_plan`` with and without it) beside the wall seconds;
    (b) ``run_rfast`` on an RF105-corrupted CommPlan raises
    ``PlanInvariantError`` before any launch; (c) ``audit_engines`` on
    the card, kernel route included, with no diagnostic and nothing
    skipped; its kernel wave loops run again under
    ``set_sync_debug_mode("error")`` (no host sync; a gradient calling
    ``.item()`` raises there and is RF201 to the audit), and the
    one-lane loop's launches and loaded libraries over two replays
    (RF205); (d) ``audit_ops`` over one chunk of (a)'s full-width wave
    loop (the LM gradient's host reads counted apart from the engine's),
    and the host syncs CUDA's sync debug mode sees in one more pass of
    the loop and in one gradient, by source line (the engine's own must
    be none); (e) ``python -m repro_torch.analysis --all --quick`` in a
    subprocess.  Returns the ``commit_grid`` launches by path."""
    import dataclasses as dc
    import os
    import warnings
    import numpy as np
    import torch
    from repro_torch.analysis import PlanInvariantError, torchlint
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.simulator import (event_generator, run_rfast,
                                            sweep_plan)
    from repro_torch.core.topology import get_topology
    from repro_torch.data.objectives import make_lm_problem
    from repro_torch.kernels import _build
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import train
    codes = lambda diags: sorted({d.code for d in diags})

    # (a) the main path with its plans linted first, and the lint's host
    # seconds over the same plans (phase 4's schedule, one eval chunk):
    # sweep_plan with the lint against without it, median of 5 each
    n, p = 4, 4096
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, 16, seed=0).schedule
    comm = build_comm_plan(topo)

    def plan_s(verify: str) -> float:
        t0 = time.perf_counter()
        sweep_plan([comm], [sched], 16, verify=verify, topos=[topo])
        return time.perf_counter() - t0

    plan_ms = {k: 1e3 * statistics.median(plan_s(v) for _ in range(5))
               for k, v in (("linted", "phase 29"), ("unlinted", ""))}
    torch.cuda.empty_cache()
    dispatch.clear()
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGS + ["--verify-plans"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    verify_launches = dispatch.launches("commit_grid")
    emit("analysis_verify_train", losses=res["losses"],
         losses_phase4=train_res["losses"], waves=res["waves"],
         commit_grid_launches=verify_launches,
         commit_grid_launches_phase4=train_launches, wall_s=wall,
         sweep_plan_ms=plan_ms,
         lint_ms=plan_ms["linted"] - plan_ms["unlinted"], device=name,
         nvidia_smi=smi)
    check(res["losses"] == train_res["losses"],
          "--verify-plans trains phase 4's losses")
    check(verify_launches == train_launches == res["waves"] > 0,
          "--verify-plans launches commit_grid once per wave, as phase 4")
    torch.cuda.empty_cache()

    # (b) a corrupted CommPlan is refused before any launch
    we = np.array(comm.w_edge)
    we[0] += 0.25
    C = torch.randn(n, p, generator=torch.Generator(device="cuda")
                    .manual_seed(0), device="cuda")
    dispatch.clear()
    try:
        run_rfast(dc.replace(comm, w_edge=we), sched,
                  lambda i, x, gen: x - C[i], torch.zeros(p, device="cuda"),
                  1e-2, verify_plans=True, device="cuda")
        raised = []
    except PlanInvariantError as e:
        raised = codes(e.diagnostics)
    emit("analysis_corrupt_plan", raised=raised,
         commit_grid_launches=dispatch.launches("commit_grid"))
    check(raised == ["RF105"] and dispatch.launches("commit_grid") == 0,
          "an RF105-corrupted CommPlan raises before any commit_grid launch")

    # (c) the engine audit on the card, kernel route included
    t0 = time.perf_counter()
    diags, audited, skipped = torchlint.audit_engines(device="cuda")
    audit_s = time.perf_counter() - t0
    loops = torchlint.engine_loops(device="cuda", impls=("kernel",))
    for loop in loops:
        _sync_free(lambda: loop.run(loop.state))
    one = loops[0]
    replays = []
    for _ in range(2):
        dispatch.clear()
        one.run(one.state)
        torch.cuda.synchronize()
        replays.append({"commit_grid": dispatch.launches("commit_grid"),
                        "loaded_libraries": len(_build._loaded)})
    item = torchlint.wave_loop(
        "m", [build_comm_plan(topo)], [sched],
        lambda i, x, gen: x - C[i] * (1 + 0 * x.sum().item()), p,
        impl="kernel", device="cuda")
    _, records = torchlint.trace_ops(item.run, item.state, in_loop=True)
    item_codes = codes(torchlint.audit_ops(records, subject="m"))
    try:
        _sync_free(lambda: item.run(item.state))
        item_raised = False
    except RuntimeError:
        item_raised = True
    torch.cuda.set_sync_debug_mode(0)
    dispatch.clear()
    emit("analysis_audit", diagnostics=[d.to_json() for d in diags],
         audited=audited, skipped=skipped, seconds=audit_s,
         sync_free_kernel_loops=[lp.subject for lp in loops],
         rf205_replays=replays, rf205_waves=one.waves,
         item_mutation={"codes": item_codes, "sync_debug_raised":
                        item_raised}, device=name, nvidia_smi=smi)
    check(diags == [] and skipped == [], "the card's audit reports 0 "
          "diagnostics and skips nothing")
    check(all(r == {"commit_grid": one.waves,
                    "loaded_libraries": replays[0]["loaded_libraries"]}
              for r in replays), "RF205: one launch per non-empty wave and "
          "no library loaded on a replay")
    check(item_codes == ["RF201"] and item_raised,
          "a gradient calling .item() is RF201 and raises in sync debug "
          "mode")
    del loops, one, item, records
    torch.cuda.empty_cache()

    # (d) the audit over one chunk of (a)'s full-width wave loop
    from repro_torch.configs import get_config
    cfg = get_config("rfast-100m")
    prob = make_lm_problem(cfg, n, batch_per_node=4, seq_len=128, seed=0,
                           device="cuda")
    g = prob.grad_fn()
    K = len(sched.agent)
    loop = torchlint.wave_loop("train[wave loop]", [build_comm_plan(topo)],
                               [sched], g, prob.p, impl="kernel",
                               device="cuda", seeds=[0])
    t0 = time.perf_counter()
    dispatch.clear()
    _, records = torchlint.trace_ops(loop.run, loop.state, in_loop=True)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    full = torchlint.audit_ops(records, subject=loop.subject)
    full_launches = dispatch.launches("commit_grid")
    _, grad_records = torchlint.trace_ops(
        g, 0, loop.state.nodes[0, 0], event_generator(0, 0, 0), in_loop=True)
    per_grad = {d.data["op"]: d.data["count"] for d in torchlint.audit_ops(
        grad_records, subject="grad") if d.code == "RF201"}
    in_loop = {d.data["op"]: d.data["count"] for d in full
               if d.code == "RF201"}
    engine_own = {op: c - K * per_grad.get(op, 0) for op, c in in_loop.items()}

    def host_syncs(fn) -> collections.Counter:
        """The host syncs CUDA's sync debug mode sees in ``fn()``, by
        the source line of the Python frame that made each."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return collections.Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message))

    loop_syncs = host_syncs(lambda: loop.run(loop.state))
    grad_syncs = host_syncs(lambda: g(0, loop.state.nodes[0, 0],
                                      event_generator(0, 0, 0)))
    emit("analysis_full_width_ops", p=prob.p, events=K, ops=len(records),
         trace_s=trace_s, ops_by_count=collections.Counter(
             r.name for r in records).most_common(8),
         diagnostics=[d.to_json() for d in full],
         rf201_per_gradient=per_grad, rf201_engine_own=engine_own,
         commit_grid_launches=full_launches, waves=loop.waves,
         host_syncs_in_loop=dict(loop_syncs),
         host_syncs_per_gradient=dict(grad_syncs),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         device=name, nvidia_smi=smi)
    check(all(v == 0 for v in engine_own.values()),
          "every host read in the full-width wave loop is the gradient's")
    check(loop_syncs == collections.Counter(
        {k: K * v for k, v in grad_syncs.items()}),
          "every host sync in the full-width wave loop is the gradient's")
    check(full_launches == loop.waves, "one commit_grid launch per wave "
          "under the trace")
    del loop, prob, g, records, grad_records
    dispatch.clear()
    torch.cuda.empty_cache()

    # (e) the CLI, as a user runs it
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--quick"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    cli_s = time.perf_counter() - t0
    report = json.loads(out.stdout) if out.returncode == 0 else {}
    emit("analysis_cli", returncode=out.returncode, seconds=cli_s,
         summary=report.get("summary"), stderr_tail=out.stderr[-600:])
    check(out.returncode == 0 and report["summary"]["diagnostics"] == 0
          and report["summary"]["skipped_programs"] == [],
          "python -m repro_torch.analysis --all --quick exits 0 on the card")
    return {"analysis_verify_train": verify_launches,
            "analysis_full_width_trace": full_launches}


# --------------------------------------------------------------------- #
# phase 30: multi-device (ranks of this one card)
# --------------------------------------------------------------------- #
def mesh_cell(layers, seeds):
    """Phase 4's cell (rfast-100m, 4 nodes, binary tree, uniform, K 16,
    batch 4 x 128, weights from seed 0) at ``layers`` layers (None: all
    12), one lane per schedule seed."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.topology import get_topology
    from repro_torch.data.objectives import make_lm_problem
    cfg = get_config("rfast-100m")
    if layers is not None:
        cfg = dc.replace(cfg, n_layers=layers)
    prob = make_lm_problem(cfg, 4, batch_per_node=4, seq_len=128, seed=0,
                           device="cuda")
    topo = get_topology("binary_tree", 4)
    scheds = [get_scenario("uniform", 4).realize(topo, 16, seed=s).schedule
              for s in seeds]
    return prob, topo, scheds


def rows_err(host, ref, cols) -> tuple[float, bool, bool]:
    """max |host − ref[..., cols]| row by row on the card (one row of the
    field on the card at a time), whether every entry is within
    ``MESH_TOL`` (absolute and relative, as the reference's
    ``assert_allclose``) and whether the two are bitwise equal."""
    import torch
    h = host.reshape(-1, host.shape[-1])
    r = ref.reshape(-1, ref.shape[-1])
    err, ok, same = 0.0, True, True
    for i in range(h.shape[0]):
        a, b = h[i].to(r.device), r[i, cols]
        d = (a - b).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= MESH_TOL * (1 + b.abs())).all())
        same = same and bool(torch.equal(a, b))
    return err, ok, same


def held_to_unsharded(host: dict, ref_state, cols) -> dict:
    """Each field of ``host`` (this rank's final lane state, on the host)
    against the unsharded run's ``ref_state`` on the card."""
    out = {f: rows_err(host[f], getattr(ref_state, f), cols)
           for f in MESH_FIELDS}
    return {"max_abs_err": {f: v[0] for f, v in out.items()},
            "within_tol": all(v[1] for v in out.values()),
            "bitwise": all(v[2] for v in out.values())}


def mesh_run(prob, topo, scheds, mesh) -> dict:
    """One ``run_sweep(mesh=...)`` of the cell on this rank, the counters
    zeroed just before and read just after: the lane states it holds
    copied to the host (the card is freed for the reference), its
    ``commit_grid`` launches and the widths ``Pf`` they launched at, the
    fleet waves, the collectives, its wall and peak."""
    import torch
    from repro_torch.core import simulator
    from repro_torch.core.runtime_sharded import (clear_collectives,
                                                  collective_stats)
    from repro_torch.kernels.rfast_update import dispatch
    seeds = list(range(len(scheds)))
    widths, launch = set(), simulator.commit_grid

    def seen(*a, **k):                 # the sources' width, as launched
        widths.add(int(a[8].shape[-1]))
        return launch(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    simulator.commit_grid = seen
    dispatch.clear()
    clear_collectives()
    t0 = time.perf_counter()
    try:
        states, metrics = simulator.run_sweep(
            topo, scheds, prob, prob.x0_flat, MESH_GAMMA, seeds=seeds,
            device="cuda", mesh=mesh,
            eval_fn=lambda st, t: {})
        torch.cuda.synchronize()
    finally:
        simulator.commit_grid = launch
    wall = time.perf_counter() - t0
    launches = dispatch.launches("commit_grid")
    stats = collective_stats()
    own = [s for s, st in enumerate(states) if st is not None]
    waves = sum(m["waves"] for m in metrics[own[0]])
    host = {s: {f: getattr(states[s], f).to("cpu") for f in MESH_FIELDS}
            for s in own}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del states
    torch.cuda.empty_cache()
    gathers = stats["by_name"].get("all_gather_flat",
                                   {"calls": 0, "bytes": 0, "seconds": 0.0})
    return {"host": host, "row": {
        "lanes": own, "commit_grid_launches": launches, "fleet_waves": waves,
        "Pf": sorted(widths), "collective_calls": stats["calls"],
        "gathers": gathers["calls"],
        "gather_bytes_per_wave": gathers["bytes"] / max(1, waves),
        "gather_s": gathers["seconds"],
        "staged_bytes": stats["staged_bytes"], "wall_s": wall,
        "max_memory_allocated_gb": peak}}


def unsharded_turns(rank: int, world: int, prob, topo, scheds,
                    check_lanes) -> dict:
    """The ranks take turns (one full-width fleet on the card at a time)
    at the unsharded ``run_sweep`` of the same lanes, each holding its
    own lanes' host states to it (``check_lanes(ref_states) -> dict``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.simulator import run_sweep
    out = None
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            ref, _ = run_sweep(topo, scheds, prob, prob.x0_flat, MESH_GAMMA,
                               seeds=list(range(len(scheds))),
                               device="cuda")
            out = check_lanes(ref)
            del ref
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_world1_rank() -> dict:
    """30(a), a world-1 NCCL group on cuda:0: the cell at full width
    (``MESH_LAYERS`` layers) through ``run_sweep(mesh=make_sweep_mesh())``
    (1 x 1), held to the unsharded ``run_sweep`` of the same lane run
    after it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    prob, topo, scheds = mesh_cell(MESH_LAYERS, [0])
    mesh = make_sweep_mesh()
    run = mesh_run(prob, topo, scheds, mesh)
    row = dict(run["row"], backend=dist.get_backend(),
               world=dist.get_world_size(), mesh=[1, 1], p=prob.p)
    row.update(unsharded_turns(0, 1, prob, topo, scheds, lambda ref:
                               held_to_unsharded(run["host"][0], ref[0],
                                                 slice(None))))
    return row


def mesh_gloo_rank() -> dict:
    """30(b) and (d) on one of two ranks sharing cuda:0 over a gloo group
    the caller asked for: the cell at full width (``MESH_LAYERS``
    layers) on a (1, 2) mesh (one lane, half the flat state a rank, one
    gather a wave), then phase
    18(b)'s two lanes at 2 layers on a (2, 1) mesh (a lane a rank), each
    held to the unsharded run of the same lanes; then the engine audit
    in the group (its 1 x 2 mesh body, RF206) and the body altered to
    gather the group's node state."""
    import torch.distributed as dist
    from repro_torch.analysis import torchlint
    from repro_torch.launch.mesh import make_sweep_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "backend": dist.get_backend()}

    prob, topo, scheds = mesh_cell(MESH_LAYERS, [0])
    mesh = make_sweep_mesh(lanes=1, param_shards=2)
    p_loc = -(-prob.p // 2)
    cols = slice(rank * p_loc, min(prob.p, (rank + 1) * p_loc))
    run = mesh_run(prob, topo, scheds, mesh)
    out["1x2"] = dict(run["row"], p=prob.p, p_loc=p_loc, **unsharded_turns(
        rank, world, prob, topo, scheds,
        lambda ref: held_to_unsharded(run["host"][0], ref[0], cols)))
    del run, prob

    prob, topo, scheds = mesh_cell(2, [0, 1])
    mesh = make_sweep_mesh(lanes=2, param_shards=1)
    run = mesh_run(prob, topo, scheds, mesh)
    out["2x1"] = dict(run["row"], p=prob.p, **unsharded_turns(
        rank, world, prob, topo, scheds,
        lambda ref: held_to_unsharded(run["host"][rank], ref[rank],
                                      slice(None))))
    del run, prob

    diags, audited, skipped = torchlint.audit_engines(device="cuda")
    out["audit"] = {"diagnostics": [d.to_json() for d in diags],
                    "audited": audited, "skipped": skipped,
                    "altered": mesh_altered_body(
                        make_sweep_mesh(lanes=1, param_shards=2))}
    return out


def mesh_altered_body(mesh) -> list:
    """RF206's mutation on ``mesh``: the two-lane fleet of the engine
    audit with a body that gathers the lane group's whole node state
    first.  Returns the codes the audit reports."""
    import torch
    from repro_torch.analysis import torchlint
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.runtime_sharded import all_gather_flat
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.topology import get_topology
    n, p, K = 5, 8, 48
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, K, seed=0).schedule
    C = torch.linspace(-1, 1, n * p, device="cuda").reshape(n, p)
    loop = torchlint.wave_loop(
        "altered", [build_comm_plan(topo)] * 2, [sched] * 2,
        lambda i, x, gen: x - C[i], p, mesh=mesh, impl="kernel",
        device="cuda")
    group = mesh.group("model")
    diags = torchlint.audit_collectives(
        lambda st: (all_gather_flat(st.nodes, group), loop.run(st))[1],
        loop.state, subject="altered",
        state_bytes_threshold=loop.state_bytes)
    return sorted({d.code for d in diags})


def sharded_problem(device):
    """tests/helpers/sharded_equiv.py's problems on ``device``: the
    dense one (C, S of n x p), and the robust one (C of n x p_r, then one
    0/1 delivery mask of (n, slots) a round at 30 % loss)."""
    import numpy as np
    import torch
    from repro_torch.core import binary_tree
    from repro_torch.core.plan import as_comm_plan
    rng = np.random.default_rng(0)
    C = rng.normal(0, 1, (SHARDED_N, SHARDED_P)).astype(np.float32)
    S = rng.uniform(0.5, 2.0, (SHARDED_N, 1)).astype(np.float32)
    plan = as_comm_plan(binary_tree(SHARDED_N))
    slots = len(plan.slots_w) + len(plan.slots_a)
    rng = np.random.default_rng(1)
    Cr = rng.normal(0, 1, (SHARDED_N, ROBUST_P)).astype(np.float32)
    masks = np.stack([(rng.uniform(size=(SHARDED_N, slots)) > ROBUST_LOSS)
                      .astype(np.float32) for _ in range(ROBUST_ROUNDS)])
    put = lambda a: torch.from_numpy(a).to(device)
    return put(C), put(S), put(Cr), put(masks)


def sharded_grad(x, batch, key):
    c, s = batch
    return 0.5 * (s * (x - c) ** 2).sum(), s * (x - c)


def robust_grad(x, c, key):
    return 0.5 * ((x - c) ** 2).sum(), x - c


def sharded_round_rank() -> dict:
    """30(c), one node of four sharing cuda:0 over a gloo group: the
    ppermute round for ``SHARDED_ROUNDS`` rounds, then robust mode for
    ``ROBUST_ROUNDS`` at 30 % loss.  Returns the node's final state."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import binary_tree
    from repro_torch.core.runtime_sharded import (clear_collectives,
                                                  collective_stats,
                                                  init_sharded_state,
                                                  make_sharded_round,
                                                  node_index, shard_state)
    from repro_torch.launch.mesh import make_sweep_mesh
    mesh = make_sweep_mesh(lanes=SHARDED_N, param_shards=1)
    na = ("data",)
    C, S, Cr, masks = sharded_problem("cuda")
    topo = binary_tree(SHARDED_N)
    out = {"rank": dist.get_rank(), "node": node_index(mesh, na),
           "backend": dist.get_backend()}
    runs = (("sync", SHARDED_P, (C, S), sharded_grad, SHARDED_GAMMA, False,
             SHARDED_ROUNDS),
            ("robust", ROBUST_P, Cr, robust_grad, ROBUST_GAMMA, True,
             ROBUST_ROUNDS))
    for tag, p, batch, gfn, gamma, robust, rounds in runs:
        st = shard_state(init_sharded_state(
            topo, torch.zeros(p, device="cuda"), gfn, batch, robust=robust),
            mesh, na)
        blk = shard_state(batch, mesh, na)
        rf = make_sharded_round(topo, gfn, mesh, gamma=gamma, node_axes=na,
                                robust=robust)
        clear_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(rounds):
            st, _ = rf(st, blk, None,
                       shard_state(masks[t], mesh, na) if robust else None)
        torch.cuda.synchronize()
        stats = collective_stats()
        out[tag] = {"wall_s": time.perf_counter() - t0, "rounds": rounds,
                    "collectives": stats,
                    "state": {f: getattr(st, f).cpu().numpy().tolist()
                              for f in ("x", "z", "g_prev", "rho_out",
                                        "rho_buf")}}
    return out


def phase_mesh(name: str, smi: str) -> dict:
    """Phase 30: multi-device on one card.  NCCL refuses two ranks on one
    card, so (a) runs a world-1 NCCL group and (b)–(c) ranks that share
    cuda:0 over a gloo group asked for explicitly (gloo carries CUDA
    gathers; its point-to-point ops are staged through pinned host
    buffers, ``runtime_sharded.STAGED``).  Every rank is a spawned
    process (``launch.multihost.spawn_local``); a rank that fails fails
    the run.  (d) the engine audit here (its 1 x 1 mesh body) and the
    altered body.  Returns ``commit_grid``'s launches by path."""
    import numpy as np
    import torch
    from repro_torch.analysis import torchlint
    from repro_torch.core import binary_tree
    from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                          make_rfast_round)
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.launch.multihost import spawn_local
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    emit("mesh_start", parent_allocated_gb=held,
         parent_reserved_gb=torch.cuda.memory_reserved() / 1e9)
    check(held < 2.0, f"the parent holds {held:.2f} GB on the card before "
          "its ranks start")
    t_phase = time.perf_counter()

    # (a) world-1 NCCL
    t0 = time.perf_counter()
    a = spawn_local(mesh_world1_rank, 1, backend=None,
                    timeout_s=MESH_TIMEOUT_S, join_s=MESH_JOIN_S)[0]
    emit("mesh_world1", **a, spawn_wall_s=time.perf_counter() - t0,
         tol=MESH_TOL, device=name, nvidia_smi=smi)
    check(a["backend"] == "nccl" and a["world"] == 1, "30(a) is NCCL")
    check(a["commit_grid_launches"] == a["fleet_waves"] == 7
          and a["Pf"] == [a["p"]], "30(a): 7 commit_grid launches at Pf = p")
    check(a["within_tol"], f"30(a) within {MESH_TOL} of the unsharded run")

    # (b) two gloo ranks sharing the card
    t0 = time.perf_counter()
    b = spawn_local(mesh_gloo_rank, 2, backend="gloo",
                    timeout_s=MESH_TIMEOUT_S, join_s=MESH_JOIN_S)
    b_wall = time.perf_counter() - t0
    for r in b:
        for sub in ("1x2", "2x1"):
            emit("mesh_rank", sub=sub, rank=r["rank"], backend=r["backend"],
                 **r[sub], tol=MESH_TOL, device=name, nvidia_smi=smi)
        emit("mesh_rank_audit", rank=r["rank"], **r["audit"])
    emit("mesh_gloo", spawn_wall_s=b_wall)
    for r in b:
        one, two = r["1x2"], r["2x1"]
        check(r["backend"] == "gloo", "30(b) is the gloo group asked for")
        check(one["commit_grid_launches"] == one["fleet_waves"] == 7
              and one["gathers"] == 7 and one["Pf"] == [one["p_loc"]],
              "30(b) (1,2): one gather and one commit_grid launch a wave, "
              "at Pf = p_loc")
        check(two["commit_grid_launches"] == two["fleet_waves"] > 0
              and two["gathers"] == 0 and two["Pf"] == [two["p"]],
              "30(b) (2,1): one commit_grid launch a wave, no collective")
        check(one["within_tol"] and two["within_tol"],
              f"30(b) within {MESH_TOL} of the unsharded runs")
        check(r["audit"]["diagnostics"] == [] and r["audit"]["skipped"] == []
              and "mesh_wave_loop[1x2,kernel]" in r["audit"]["audited"]
              and r["audit"]["altered"] == ["RF206"],
              "30(d) in the group: the 1 x 2 mesh body is clean, the altered "
              "body is RF206")

    # (c) the ppermute round, four gloo ranks
    t0 = time.perf_counter()
    c = spawn_local(sharded_round_rank, SHARDED_N, backend="gloo",
                    timeout_s=MESH_TIMEOUT_S, join_s=MESH_JOIN_S)
    c_wall = time.perf_counter() - t0
    by_node = sorted(c, key=lambda r: r["node"])
    stacked = lambda tag, f: np.concatenate(
        [np.asarray(r[tag]["state"][f], np.float32) for r in by_node])
    C, S, Cr, _ = sharded_problem("cuda")
    topo = binary_tree(SHARDED_N)
    spec = edge_arrays(topo)
    st = init_node_state(spec, torch.zeros(SHARDED_P, device="cuda"),
                         sharded_grad, (C, S))
    rf = make_rfast_round(spec, sharded_grad, gamma=SHARDED_GAMMA)
    for _ in range(SHARDED_ROUNDS):
        st, _m = rf(st, (C, S), None, None)
    dense_err = float(np.abs(stacked("sync", "x") - st.x.cpu().numpy()).max())
    x_star = ((S * C).sum(0) / S.sum(0)).cpu().numpy()
    res = {}
    for tag, target in (("sync", x_star), ("robust", Cr.mean(0).cpu()
                                           .numpy())):
        mass = stacked(tag, "z").sum(0) + (stacked(tag, "rho_out")
                                           - stacked(tag, "rho_buf")).sum(
            (0, 1))
        res[tag] = {"lemma3_max_abs": float(np.abs(
            mass - stacked(tag, "g_prev").sum(0)).max()),
            "conv": float(np.abs(stacked(tag, "x") - target[None]).max()),
            "wall_s": max(r[tag]["wall_s"] for r in c),
            "collectives_a_rank": c[0][tag]["collectives"]}
    emit("mesh_sharded_round", ranks=SHARDED_N, backend=c[0]["backend"],
         p=SHARDED_P, rounds=SHARDED_ROUNDS, dense_max_abs_err=dense_err,
         robust_p=ROBUST_P, robust_rounds=ROBUST_ROUNDS, loss=ROBUST_LOSS,
         **res, spawn_wall_s=c_wall, tol=ROUND_TOL, device=name,
         nvidia_smi=smi)
    check(dense_err <= ROUND_TOL, f"30(c): the ppermute round within "
          f"{ROUND_TOL} of the dense round")
    check(res["sync"]["lemma3_max_abs"] <= ROUND_TOL
          and res["robust"]["lemma3_max_abs"] <= ROUND_TOL,
          "30(c): Lemma 3 on the slotted layout")
    check(res["sync"]["conv"] < 1e-2 and res["robust"]["conv"] < 5e-2,
          "30(c): converges (and under 30 % loss)")
    check(c[0]["robust"]["collectives"]["staged_bytes"] > 0,
          "30(c): gloo's point-to-point on CUDA tensors is staged")
    del st, C, S, Cr
    torch.cuda.empty_cache()

    # (d) RF206 here: the engine audit's 1 x 1 mesh body, the altered one
    t0 = time.perf_counter()
    diags, audited, skipped = torchlint.audit_engines(device="cuda")
    altered = mesh_altered_body(make_sweep_mesh())
    emit("mesh_rf206", diagnostics=[d.to_json() for d in diags],
         mesh_subjects=[s for s in audited if s.startswith("mesh_")],
         skipped=skipped, altered=altered,
         seconds=time.perf_counter() - t0)
    check(diags == [] and skipped == [] and {
        "mesh_wave_loop[1x1,plain]", "mesh_wave_loop[1x1,kernel]"}
        <= set(audited), "30(d): the mesh body is clean on the card")
    check(altered == ["RF206"], "30(d): the altered body is RF206")
    emit("mesh_done", seconds=time.perf_counter() - t_phase)
    return {"mesh_1x1": a["commit_grid_launches"],
            **{f"mesh_1x2_rank{r['rank']}": r["1x2"]["commit_grid_launches"]
               for r in b},
            **{f"mesh_2x1_rank{r['rank']}": r["2x1"]["commit_grid_launches"]
               for r in b}}


# --------------------------------------------------------------------- #
# phase 31: the launch tooling
# --------------------------------------------------------------------- #
def launch_case(tag: str, build, cfg, mesh, kw: dict, name: str,
                smi: str) -> tuple[dict, dict, dict]:
    """One case of phase 31: ``build`` (a ``launch.specs`` build function) on
    meta under ``launch.dryrun.measure``, then the same case on cuda:0
    from seed 0 run twice (``launch.dryrun.run_live``), the meta
    predictions checked against it.  Returns (meta record, live record,
    live args' extra: the decode bound for a decode case)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import terms_s
    t0 = time.perf_counter()
    fn, args = build(cfg, mesh, device="meta", **kw)
    rec = dict(dryrun.measure(fn, args), case=fn.info)
    meta_s = time.perf_counter() - t0
    del fn, args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fn, args = build(cfg, mesh, device="cuda", seed=0, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    live = dryrun.run_live(fn, args, runs=2)
    extra = {}
    if fn.info["kind"] == "decode":
        extra = decode_bound(cfg, args[0], args[1], args[2].shape[0])
    del fn, args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    meta_launches = {k: v["launches"] for k, v in rec["kernels"].items()}
    temp = rec["memory"]["temp_size_in_bytes"]
    peak = live["peak_above_args_bytes"][-1]
    wall = statistics.median(live["wall_s"])
    emit("launch_" + tag, meta=dict(
        memory=rec["memory"], cost_scanned=rec["cost_scanned"],
        flops_aten=rec["flops_aten"], flops_kernels=rec["flops_kernels"],
        bytes_aten=rec["bytes_aten"], bytes_kernels=rec["bytes_kernels"],
        kernels=rec["kernels"], roofline_terms_s=terms_s(rec),
        fp32_compute_s=rec["cost_scanned"]["flops"] / FP32_FLOP_PER_S,
        seconds=meta_s),
        live=dict(live, build_s=build_s, median_wall_s=wall),
        peak_over_temp=peak / temp if temp else None,
        temp_band=LAUNCH_TEMP_BAND, temp_slack_bytes=LAUNCH_TEMP_SLACK,
        case=rec["case"], device=name,
        nvidia_smi=smi, **({"decode_bound": extra} if extra else {}))
    check(live["argument_size_in_bytes"]
          == rec["memory"]["argument_size_in_bytes"],
          f"31 {tag}: the live arguments' bytes equal the meta prediction "
          f"({live['argument_size_in_bytes']} vs "
          f"{rec['memory']['argument_size_in_bytes']})")
    check(all(run == meta_launches for run in live["launches"]),
          f"31 {tag}: each run launches what the meta record counts "
          f"({live['launches']} vs {meta_launches})")
    check(live["flops_aten"] == rec["flops_aten"],
          f"31 {tag}: FlopCounterMode over the live step equals the meta "
          f"aten FLOPs ({live['flops_aten']} vs {rec['flops_aten']})")
    check(abs(peak - temp) <= LAUNCH_TEMP_BAND * temp + LAUNCH_TEMP_SLACK,
          f"31 {tag}: the live peak above the arguments ({peak} B) within "
          f"{LAUNCH_TEMP_BAND:.0%} + {LAUNCH_TEMP_SLACK} B of the meta temp "
          f"({temp} B)")
    return rec, live, extra


def phase_launch(name: str, smi: str) -> dict:
    """Phase 31: the launch tooling's meta predictions against the card
    (the module docstring's 31(a)-(d)).  Returns ``commit_grid``'s
    launches of (a)'s live rounds."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import HW, describe_mesh
    from repro_torch.launch.roofline import analyze_record
    t_phase = time.perf_counter()

    # (a) phase 11's cell: a dense round at full width, fp32
    cfg = get_config("rfast-100m")
    rec, live, _ = launch_case(
        "train", specs.build_train, cfg,
        describe_mesh((4, 1), ("data", "model")),
        dict(LAUNCH_TRAIN, dtype=torch.float32), name, smi)
    train_launches = sum(r.get("commit_grid", 0) for r in live["launches"])
    check(rec["kernels"]["commit_grid"]["launches"] == 1,
          "31(a): one commit_grid launch a round")

    # (b) llama3-8b's decode step at full depth, fp32 (as it is served)
    cfg = get_config("llama3-8b")
    rec, live, bound = launch_case(
        "decode", specs.build_decode, cfg,
        describe_mesh((1, 1), ("data", "model")),
        dict(LAUNCH_DECODE, dtype=torch.float32), name, smi)
    emit("launch_decode_bytes", meta_bytes=rec["cost_scanned"]["bytes"],
         bound_bytes=bound["bytes"],
         meta_over_bound=rec["cost_scanned"]["bytes"] / bound["bytes"],
         bound_ms=bound["bound_ms"],
         median_step_ms=statistics.median(live["wall_s"]) * 1e3,
         meta_memory_term_ms=rec["cost_scanned"]["bytes"] / HW["hbm_bw"]
         * 1e3, device=name, nvidia_smi=smi)
    check(rec["cost_scanned"]["bytes"] >= bound["bytes"],
          "31(b): the meta bytes count at least the decode bound's")

    # (c) the constants beside the card
    props = torch.cuda.get_device_properties(0)
    emit("launch_hw", hw=HW, sms=props.multi_processor_count,
         max_sm_clock_hz=sm_clock_hz(), total_memory=props.total_memory,
         device=name, nvidia_smi=smi)
    check(props.multi_processor_count == H100_SMS,
          f"31(c): {H100_SMS} SMs, as launch.mesh says")

    # (d) one production case on meta: a rank of the (32, 8) mesh
    rec = dryrun.run_case("llama3-8b", "train_4k", fit=False, verbose=False)
    row = analyze_record(rec)
    emit("launch_production", row=row, memory=rec.get("memory"),
         collectives=rec.get("collectives_scanned"), case=rec.get("case"),
         seconds=rec.get("compile_s"), device=name, nvidia_smi=smi)
    check(rec["ok"] and rec["model_axis"] == "tensor" and row["fits_hbm"],
          "31(d): llama3-8b train_4k runs on meta tensor-parallel, and a "
          "rank's arguments and temporaries fit one card")
    emit("launch_done", seconds=time.perf_counter() - t_phase)
    return {"launch_tooling_train": train_launches}


# --------------------------------------------------------------------- #
# phases 32-33: the model axis tensor-parallel
# --------------------------------------------------------------------- #
def tp_config(arch: str, layers: int | None = None):
    """``arch``'s config at full width, cut to ``layers`` of its layers
    (and of its encoder's; None: all of them)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=min(
        cfg.n_enc_layers, layers))


def tp_reference(rank: int, cfg, nodes: dict, rounds: int) -> dict:
    """The dense round of a tensor-parallel cell of ``cfg``
    (``build_train(comm="dense")``, ``impl="kernel"``, ``TP_TRAIN``) on
    the card for ``rounds`` rounds: the rows of x, z and g_prev of node
    ``nodes[rank]``, and the launches of every kernel."""
    import torch
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import describe_mesh
    fn, (st, batch, _) = specs.build_train(
        cfg, describe_mesh((2, 1), ("data", "model")), comm="dense",
        device="cuda", dtype=torch.float32, **TP_TRAIN)
    dispatch.clear()
    for _ in range(rounds):
        st, _m = fn(st, batch)
    i = nodes[rank]
    ref = {f: getattr(st, f)[i].clone() for f in ("x", "z", "g_prev")}
    ref.update(node=i, launches=dispatch.stats()["by_kernel"])
    del st, batch, fn
    torch.cuda.empty_cache()
    return ref


def tp_warmup(cfg) -> None:
    """One plain gradient of a tensor-parallel cell of ``cfg`` on the
    card: the first CUDA work of a rank (its context, cuBLAS, the
    kernels' modules) done while the reference ranks run the dense
    round, not inside a cell."""
    import torch
    from repro_torch.core.paramvec import make_ravel_spec, ravel, \
        value_and_grad
    from repro_torch.models.transformer import init_params, loss_fn
    tree = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    spec = make_ravel_spec(tree)
    b = TP_TRAIN["global_batch"] // 2
    toks = torch.zeros((b, TP_TRAIN["seq"]), dtype=torch.long, device="cuda")
    front = (torch.zeros((b, cfg.frontend_seq, cfg.frontend_dim),
                         device="cuda"),) if cfg.frontend else ()
    value_and_grad(spec, lambda p, b, k: loss_fn(cfg, p, b, b, *front,
                                                 remat=True))(
        ravel(spec, tree), toks, None)
    torch.cuda.synchronize()
    del tree
    torch.cuda.empty_cache()


def tp_cell(mesh, ref: dict, cfg, rounds: int) -> dict:
    """32(a)/(b), 33(b) on one rank of ``mesh``: a tensor-parallel cell
    of ``cfg`` built by ``build_train(comm="ppermute")`` on the card and
    on meta (the argument bytes), ``rounds`` rounds (seconds and
    collectives a round; the last under RF206's audit; the kernels'
    launches over all of them), the replicated leaves against the model
    group's, and the state rows gathered whole against the dense rows in
    ``ref`` (if this rank holds them for its node here)."""
    import torch
    from repro_torch.analysis import torchlint
    from repro_torch.core.runtime_sharded import (all_gather_seq,
                                                  clear_collectives,
                                                  collective_stats)
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _distinct_bytes
    from repro_torch.launch.mesh import describe_mesh
    from repro_torch.models import sharding as msh
    D, M = mesh.shape["data"], mesh.shape["model"]
    kw = dict(TP_TRAIN, comm="ppermute", dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn, (st, batch, _) = specs.build_train(cfg, mesh, device="cuda", **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, meta_args = specs.build_train(
        cfg, describe_mesh((D, M), ("data", "model"), rank=mesh.rank), **kw)
    tp, spec = fn.tensor_parallel, fn.ravel_spec
    out = {"mesh": [D, M], "coords": mesh.coords, "info": fn.info,
           "build_s": build_s,
           "live_argument_bytes": _distinct_bytes(
               specs.tensors_of((st, batch))),
           "meta_argument_bytes": _distinct_bytes(
               specs.tensors_of(meta_args)),
           "round_s": [], "collectives": []}
    del meta_args
    dispatch.clear()
    for r in range(rounds):
        clear_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if r < rounds - 1:
            st, metrics = fn(st, batch)
        else:                   # the last round under RF206's audit
            done = []
            out["audit"] = [d.code for d in
                            torchlint.audit_tensor_parallel_round(
                                lambda s: done.append(fn(s, batch)), st,
                                subject=f"tp_round[{D}x{M}]")]
            st, metrics = done[0]
        torch.cuda.synchronize()
        out["round_s"].append(time.perf_counter() - t0)
        c = collective_stats()
        out["collectives"].append({k: c[k] for k in (
            "calls", "bytes", "staged_bytes", "seconds")} | {"by_name": {
                k: {f: v[f] for f in ("calls", "bytes", "staged_bytes")}
                for k, v in c["by_name"].items()}})
    out["launches"] = dispatch.stats()["by_kernel"]
    out["losses"] = metrics["losses"].tolist()
    rep = torch.cat([st.x[0, o:o + math.prod(shape)] for path, shape, o in
                     zip(spec.paths, spec.shapes, spec.offsets)
                     if tp.dims[path] is None])
    every = all_gather_seq(rep, tp.group, 0).view(M, -1)
    out["replicated_elements"] = rep.numel()
    out["replicated_bitwise"] = all(torch.equal(every[0], every[m])
                                    for m in range(1, M))
    del rep, every
    out["rel_err"] = {}
    held = ref.get("node") == mesh.coords["data"]
    for f in ("x", "z", "g_prev"):
        whole = msh.gather_flat(getattr(st, f)[0], spec, tp)
        if held:
            want = ref[f]
            out["rel_err"][f] = float((whole - want).abs().max()
                                      / want.abs().max())
        del whole
    del st, batch, fn
    torch.cuda.empty_cache()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def routed(fn):
    """``(fn(), routes)``: each ``moe._slots`` call's (experts, kept) in
    ``fn``, on the host (none without MoE)."""
    from repro_torch.models import moe as moe_mod
    seen, slots = [], moe_mod._slots

    def rec(c, expert_idx, C, *offset):
        pos, keep = slots(c, expert_idx, C, *offset)
        seen.append((expert_idx.cpu(), keep.cpu()))
        return pos, keep
    moe_mod._slots = rec
    try:
        return fn(), seen
    finally:
        moe_mod._slots = slots


def routes_digest(routes) -> str:
    """A digest of :func:`routed`'s routes, for equality across ranks."""
    import hashlib
    return hashlib.sha256(b"".join(t.numpy().tobytes() for r in routes
                                   for t in r)).hexdigest()


def tp_grad(mesh, cfg, *, batch: int, seq: int, seq_parallel: bool,
            remat: bool) -> dict:
    """32(c), 33(a), 34(a)/(b), 35(a)/(b) on one rank of a model group:
    the ranks in turn draw ``cfg`` on the card from seed 0, keep their
    blocks on the host and take the unsharded gradient of one batch of
    ``batch`` sequences of ``seq`` tokens (after a frontend arch's
    frames or patches, drawn too) leaf by leaf, keeping this rank's
    blocks of it on the host; then every rank's tensor-parallel gradient
    of the same batch on the card (the kernels' launches and the scan
    kernels' shapes read around it alone) is held to them.  Both runs'
    MoE routes (each ``moe._slots`` call's experts and kept choices;
    none without MoE) and the card's memory in use (all ranks) after
    each."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.paramvec import (make_ravel_spec, ravel,
                                           tree_leaves, tree_map)
    from repro_torch.core.runtime_sharded import (clear_collectives,
                                                  collective_stats)
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.models import sharding as msh
    from repro_torch.models.transformer import (init_params, loss_fn,
                                                param_shapes)
    tp = msh.tensor_parallel(cfg, param_shapes(cfg), mesh,
                             seq_parallel=seq_parallel)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = tuple(torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device="cuda") for _ in range(2))
    if cfg.frontend:
        toks += (torch.randn((batch, cfg.frontend_seq, cfg.frontend_dim),
                             generator=gen, device="cuda"),)
    lf = lambda p, b, k: loss_fn(cfg, p, *b, remat=remat)
    used = lambda: (lambda f, t: (t - f) / 1e9)(*torch.cuda.mem_get_info())
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "seq_parallel": tp.seq_parallel,
           "vocab_parallel": tp.vocab_parallel,
           "expert_parallel": tp.expert_parallel,
           "enc_seq_parallel": tp.enc_seq_parallel,
           "gathered": sorted("/".join(b) for b in tp.gathered),
           "partial": sorted("/".join(b) for b in tp.partial),
           "card_used_gb": []}
    for turn in range(tp.size):
        dist.barrier(group=tp.group.pg)
        if turn != tp.index:
            continue
        t0 = time.perf_counter()
        full = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        local = msh.local_tree(full, tp)
        spec = make_ravel_spec(local)
        x_host = ravel(spec, local).cpu()
        del local
        # (a comprehension: a loop variable would keep the last leaf and
        # its gradient alive after the turn)
        leaves = [t.requires_grad_(True) for t in tree_leaves(full)]
        out["p_whole"] = sum(t.numel() for t in leaves)

        def unsharded():        # forward and backward (its recompute)
            loss = lf(full, toks, None)
            loss.backward()
            return loss
        loss, whole_routes = routed(unsharded)
        out["card_used_gb"].append(used())
        out["dense_loss"] = float(loss.detach())
        out["g_max"] = max(float(v.abs()) for t in leaves
                           for v in t.grad.aminmax())
        want_host = ravel(spec, msh.local_tree(tree_map(
            lambda t: t.grad, full), tp)).cpu()
        del full, leaves, loss
        torch.cuda.empty_cache()
        out["unsharded_s"] = time.perf_counter() - t0
    dist.barrier(group=tp.group.pg)
    x = x_host.cuda()
    del x_host
    grad = msh.tensor_parallel_grad(spec, lf, tp)
    shapes = []

    def seen(kernel, call):         # the scan calls' (B, S, di, N)
        def f(u, dt, A, *rest, **kw):
            shapes.append([kernel, *u.shape, A.shape[-1]])
            return call(u, dt, A, *rest, **kw)
        return f
    calls = scan_ops.ssm_scan, scan_ops.ssm_scan_bwd
    scan_ops.ssm_scan = seen("ssm_scan", calls[0])
    scan_ops.ssm_scan_bwd = seen("ssm_scan_bwd", calls[1])
    try:
        clear_collectives()
        dispatch.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, g), routes = routed(lambda: grad(x, toks, None))
        torch.cuda.synchronize()
        out["grad_s"] = time.perf_counter() - t0
        out["launches"] = dispatch.stats()["by_kernel"]
    finally:
        scan_ops.ssm_scan, scan_ops.ssm_scan_bwd = calls
    out["collectives"] = collective_stats()
    out["card_used_gb"].append(used())
    del x
    err, step = 0.0, 1 << 26
    for i in range(0, spec.p, step):
        err = max(err, float((g[i:i + step] - want_host[i:i + step].cuda())
                             .abs().max()))
    out.update(p_local=spec.p, loss=float(loss), scan_calls=shapes,
               rel_err=err / out["g_max"],
               shapes={"/".join(k): v for k, v in zip(spec.paths,
                                                     spec.shapes)},
               routes_equal_unsharded=len(routes) == len(whole_routes)
               and all(torch.equal(a, c) and torch.equal(b, d)
                       for (a, b), (c, d) in zip(routes, whole_routes)),
               route_calls=len(routes),
               drops=[int((~k).sum()) for _, k in routes],
               routes_digest=routes_digest(routes))
    del g, want_host
    torch.cuda.empty_cache()
    dist.barrier(group=tp.group.pg)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def tp_rank() -> dict:
    """Phase 32 on one of ``TP_WORLD`` gloo ranks sharing cuda:0: the dense
    reference rows (the ranks of ``TP_REF_NODES``; the others warm up
    meanwhile), then each of
    ``TP_MESHES`` on the first ranks of the world, then llama3-8b's
    gradient on ranks 0-3; every rank builds every mesh (its groups are
    made collectively) and waits at a barrier after each."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    cfg = tp_config("rfast-100m")
    t0 = time.perf_counter()
    ref = (tp_reference(rank, cfg, TP_REF_NODES, TP_ROUNDS)
           if rank in TP_REF_NODES else {})
    if not ref:
        tp_warmup(cfg)
    out["reference_s"] = time.perf_counter() - t0
    out["commit_grid_launches"] = ref.pop("launches", {}).get(
        "commit_grid", 0)
    dist.barrier()
    for D, M in TP_MESHES:
        mesh = make_sweep_mesh(lanes=D, param_shards=M, ranks=range(D * M))
        if mesh.coords is not None:
            t0 = time.perf_counter()
            out[f"{D}x{M}"] = dict(tp_cell(mesh, ref, cfg, TP_ROUNDS),
                                   seconds=time.perf_counter() - t0)
        dist.barrier()
    del ref
    torch.cuda.empty_cache()
    mesh = make_sweep_mesh(lanes=1, param_shards=TP_LLAMA_M,
                           ranks=range(TP_LLAMA_M))
    if mesh.coords is not None:
        t0 = time.perf_counter()
        out["llama"] = dict(tp_grad(
            mesh, tp_config("llama3-8b", TP_LLAMA_LAYERS), batch=TP_LLAMA_B,
            seq=TP_LLAMA_S, seq_parallel=True, remat=True),
            seconds=time.perf_counter() - t0)
    dist.barrier()
    return out


def tp_world_rank() -> dict:
    """Phases 32-36 on one of ``TP_WORLD`` gloo ranks sharing cuda:0, in
    one spawn (a rank's CUDA context, its first kernels and its gloo
    groups made once): each phase's rank function in turn, with the
    seconds it took on this rank."""
    out = {}
    for key, fn in (("32", tp_rank), ("33", tp_ssm_rank),
                    ("34", tp_moe_rank), ("35", tp_front_rank),
                    ("36", tp_serve_rank)):
        t0 = time.perf_counter()
        out[key] = dict(fn(), rank_s=time.perf_counter() - t0)
    return out


def tp_spawn() -> dict:
    """The ranks of phases 32-36, spawned once: ``{phase: [each rank's
    result]}``."""
    import torch
    from repro_torch.launch.multihost import spawn_local
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = spawn_local(tp_world_rank, TP_WORLD, backend="gloo",
                       timeout_s=MESH_TIMEOUT_S, join_s=MESH_JOIN_S)
    emit("tp_spawn", ranks=TP_WORLD, seconds=time.perf_counter() - t0,
         phase_s={k: max(o[k]["rank_s"] for o in outs) for k in outs[0]})
    return {k: [o[k] for o in outs] for k in outs[0]}


def phase_tensor_parallel(name: str, smi: str, outs: list) -> dict:
    """Phase 32: the model axis tensor-parallel on ranks sharing this
    card over gloo (see the module docstring), from the ranks' results
    ``outs`` (``tp_spawn``).  Returns the dense reference's
    ``commit_grid`` launches."""
    t_phase = time.perf_counter()
    for o in outs:
        for D, M in TP_MESHES:
            c = o.get(f"{D}x{M}")
            if c is None:
                continue
            emit("tp_rank", rank=o["rank"], backend=o["backend"],
                 **{k: v for k, v in c.items() if k != "info"},
                 model_axis=c["info"]["model_axis"], p=c["info"]["p"],
                 p_whole=c["info"]["p_whole"],
                 seq_parallel=c["info"]["seq_parallel"],
                 tensor_parallel=c["info"]["tensor_parallel"],
                 tol=TP_TOL, device=name, nvidia_smi=smi)
        if "llama" in o:
            emit("tp_llama_rank", rank=o["rank"], **o["llama"], tol=TP_TOL,
                 device=name, nvidia_smi=smi)
    emit("tp_done", seconds=max(o["rank_s"] for o in outs)
         + time.perf_counter() - t_phase,
         reference_s=max(o["reference_s"] for o in outs))
    for D, M in TP_MESHES:
        cells = [o[f"{D}x{M}"] for o in outs if f"{D}x{M}" in o]
        check(len(cells) == D * M, f"32: every rank of ({D}, {M}) ran")
        for c in cells:
            info = c["info"]
            check(info["model_axis"] == "tensor" and info["seq_parallel"]
                  and info["tensor_parallel"] == {
                      "ranks": M, "gathered": [], "vocab_parallel": True},
                  f"32 ({D}, {M}): tensor-parallel, sequence-parallel, "
                  "whole heads a rank")
            check(c["live_argument_bytes"] == c["meta_argument_bytes"],
                  f"32 ({D}, {M}): the live argument bytes a rank "
                  f"({c['live_argument_bytes']}) equal the meta dry-run's "
                  f"({c['meta_argument_bytes']})")
            check(c["replicated_bitwise"] and c["replicated_elements"]
                  == 19_200, f"32 ({D}, {M}): the norm scales bitwise "
                  "equal across the model group")
            check(c["audit"] == [], f"32 ({D}, {M}): the round audits clean "
                  "(RF206)")
            check(len({tuple(x["losses"]) for x in cells}) == 1,
                  f"32 ({D}, {M}): every rank reports the same losses")
            if c["rel_err"]:
                check(all(v <= TP_TOL for v in c["rel_err"].values()),
                      f"32 ({D}, {M}): the gathered state within {TP_TOL} "
                      f"of the dense round ({c['rel_err']})")
        held = sum(1 for c in cells if c["rel_err"])
        check(held == D, f"32 ({D}, {M}): both nodes held to the dense "
              "round")
    two = [o["2x2"] for o in outs if "2x2" in o]
    check(all(c["info"]["p"] == TP_P_2X2 and c["live_argument_bytes"]
              == 5 * TP_P_2X2 * 4 + 2 * 4 * 128 * 4 for c in two),
          f"32 (2, 2): 5 rows of {TP_P_2X2} fp32 elements and the batch a "
          "rank")
    llama = [o["llama"] for o in outs if "llama" in o]
    check(len(llama) == TP_LLAMA_M and all(
        r["rel_err"] <= TP_TOL for r in llama),
        f"32(c): llama3-8b's tensor-parallel gradient within {TP_TOL} of "
        "the unsharded one")
    check(len({r["loss"] for r in llama}) == 1 and all(
        abs(r["loss"] - r["dense_loss"]) <= TP_TOL * abs(r["dense_loss"])
        for r in llama), "32(c): one loss a model group, the unsharded one")
    check(sum(r["p_local"] for r in llama) > llama[0]["p_whole"],
          "32(c): a rank holds its blocks (and the norm scales whole)")
    return {"tp_dense_reference": sum(o["commit_grid_launches"]
                                      for o in outs)}


def tp_ssm_rank() -> dict:
    """Phase 33 on one of ``TP_WORLD`` gloo ranks sharing cuda:0 (ranks
    0-3 take part, the others wait at the barriers): the
    dense reference rows of hymba-1.5b's cell (the ranks of
    ``TP_HYMBA_REF_NODES``; the others warm up meanwhile), the cell on
    ``TP_HYMBA_MESH``, then falcon-mamba-7b's gradient on a model group
    of ``TP_FALCON_M``; every rank builds every mesh and waits at a
    barrier after each."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    hymba = tp_config("hymba-1.5b", TP_HYMBA_LAYERS)
    t0 = time.perf_counter()
    ref = (tp_reference(rank, hymba, TP_HYMBA_REF_NODES, TP_HYMBA_ROUNDS)
           if rank in TP_HYMBA_REF_NODES else {})
    if not ref:
        tp_warmup(hymba)
    out["reference_s"] = time.perf_counter() - t0
    out["reference_launches"] = ref.pop("launches", {})
    dist.barrier()
    D, M = TP_HYMBA_MESH
    mesh = make_sweep_mesh(lanes=D, param_shards=M, ranks=range(D * M))
    if mesh.coords is not None:
        t0 = time.perf_counter()
        out["hymba"] = dict(tp_cell(mesh, ref, hymba, TP_HYMBA_ROUNDS),
                            seconds=time.perf_counter() - t0)
    dist.barrier()
    del ref
    torch.cuda.empty_cache()
    mesh = make_sweep_mesh(lanes=1, param_shards=TP_FALCON_M,
                           ranks=range(TP_FALCON_M))
    if mesh.coords is not None:
        t0 = time.perf_counter()
        out["falcon"] = dict(tp_grad(
            mesh, tp_config("falcon-mamba-7b", TP_FALCON_LAYERS),
            batch=TP_FALCON_B, seq=TP_FALCON_S, seq_parallel=False,
            remat=False), seconds=time.perf_counter() - t0)
    dist.barrier()
    return out


def phase_tensor_parallel_ssm(name: str, smi: str, outs: list) -> dict:
    """Phase 33: the SSM archs' ``model`` axis tensor-parallel on ranks
    sharing this card over gloo, from the ranks' results ``outs``
    (``tp_spawn``), then both scan kernels held to their plain twins and
    timed at the ranks' shapes (see the module docstring).  Returns the
    paths' launches by kernel, the kernels' largest errors and their
    rows at the rank shapes."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as scan_k
    t_phase = time.perf_counter()
    D, M = TP_HYMBA_MESH
    cells = [o["hymba"] for o in outs if "hymba" in o]
    falcon = [o["falcon"] for o in outs if "falcon" in o]
    for o in outs:
        if "hymba" in o:
            c = o["hymba"]
            emit("tp_ssm_hymba_rank", rank=o["rank"], backend=o["backend"],
                 **{k: v for k, v in c.items() if k != "info"},
                 model_axis=c["info"]["model_axis"], p=c["info"]["p"],
                 p_whole=c["info"]["p_whole"],
                 seq_parallel=c["info"]["seq_parallel"],
                 tensor_parallel=c["info"]["tensor_parallel"],
                 reference_launches=o["reference_launches"], tol=TP_TOL,
                 device=name, nvidia_smi=smi)
        if "falcon" in o:
            emit("tp_ssm_falcon_rank", rank=o["rank"], **o["falcon"],
                 tol=TP_TOL, device=name, nvidia_smi=smi)
    emit("tp_ssm_ranks_done", seconds=max(o["rank_s"] for o in outs),
         reference_s=max(o["reference_s"] for o in outs))
    L = TP_HYMBA_LAYERS
    check(len(cells) == D * M, f"33(b): every rank of ({D}, {M}) ran")
    for c in cells:
        info = c["info"]
        check(info["model_axis"] == "tensor" and info["seq_parallel"]
              and info["tensor_parallel"] == {
                  "ranks": M, "gathered": ["layers/attn"],
                  "vocab_parallel": False},
              f"33(b) hymba ({D}, {M}): tensor-parallel, sequence-parallel, "
              "the attention gathered, the vocab replicated")
        check(c["live_argument_bytes"] == c["meta_argument_bytes"],
              f"33(b): the live argument bytes a rank "
              f"({c['live_argument_bytes']}) equal the meta dry-run's "
              f"({c['meta_argument_bytes']})")
        check(c["replicated_bitwise"] and c["replicated_elements"]
              == TP_HYMBA_REPLICATED, "33(b): the embedding, the head and "
              "the norm scales bitwise equal across the model group")
        check(c["audit"] == [], "33(b): the round audits clean (RF206)")
        check(len({tuple(x["losses"]) for x in cells}) == 1,
              "33(b): every rank reports the same losses")
        # a round is one gradient a rank, its layers recomputed (remat)
        check(c["launches"].get("ssm_scan_bwd") == L * TP_HYMBA_ROUNDS
              and c["launches"].get("ssm_scan") == 2 * L * TP_HYMBA_ROUNDS,
              f"33(b): the scan kernels on a rank's channels, once forward "
              f"(and once recomputed) and once backward a layer a round "
              f"({c['launches']})")
        if c["rel_err"]:
            check(all(v <= TP_TOL for v in c["rel_err"].values()),
                  f"33(b): the gathered state within {TP_TOL} of the dense "
                  f"round ({c['rel_err']})")
    check(sum(1 for c in cells if c["rel_err"]) == D,
          "33(b): both nodes held to the dense round")
    fl = TP_FALCON_LAYERS
    want_shape = [TP_FALCON_B, TP_FALCON_S, TP_FALCON_DI // TP_FALCON_M, 16]
    check(len(falcon) == TP_FALCON_M and all(
        r["rel_err"] <= TP_TOL for r in falcon),
        f"33(a): falcon-mamba-7b's tensor-parallel gradient within {TP_TOL} "
        "of the unsharded one")
    check(len({r["loss"] for r in falcon}) == 1 and all(
        abs(r["loss"] - r["dense_loss"]) <= TP_TOL * abs(r["dense_loss"])
        for r in falcon), "33(a): one loss a model group, the unsharded one")
    check(all(r["p_whole"] == TP_FALCON_P and r["vocab_parallel"]
              and r["gathered"] == [] for r in falcon),
          f"33(a): {TP_FALCON_P} parameters, vocab-parallel, no block "
          "gathered")
    check(all(r["launches"] == {"ssm_scan": fl, "ssm_scan_bwd": fl}
              and r["scan_calls"] == [[k, *want_shape] for k in
                                      ("ssm_scan",) * fl
                                      + ("ssm_scan_bwd",) * fl]
              for r in falcon),
          f"33(a): ssm_scan and ssm_scan_bwd launched {fl} times a rank's "
          f"gradient at (B, S, d_inner / M, N) = {want_shape}")
    # the kernels at the ranks' shapes: held to their twins, then timed
    clock_hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = {"ssm_scan": 0.0, "ssm_scan_bwd": 0.0}
    rows = {"ssm_scan": {}, "ssm_scan_bwd": {}}
    for sname, shape, dt_rank in TP_SCAN_SHAPES + TP_SCAN_WIDTHS:
        sargs = scan_inputs(*shape, torch.float32, dt_rank=dt_rank, seed=9)
        fe = compare_scan(sargs, SCAN_FP32_TOL, f"ssm_scan {sname}")
        brel, be = compare_scan_bwd(sargs, SCAN_FP32_TOL,
                                    f"ssm_scan_bwd {sname}", seed=10)
        err["ssm_scan"] = max(err["ssm_scan"], fe)
        err["ssm_scan_bwd"] = max(err["ssm_scan_bwd"], be)
        emit("tp_scan_kernel", shape=sname,
             case=dict(zip(("B", "S", "di", "N"), shape)),
             segments=scan_k.scan_segments(*shape, sms), max_abs_err=fe,
             bwd_max_abs_err=be, bwd_max_rel_err=brel, tol=SCAN_FP32_TOL)
        del sargs
        if (sname, shape, dt_rank) in TP_SCAN_SHAPES:
            rows["ssm_scan"][sname], rows["ssm_scan_bwd"][sname] = \
                scan_timing(sname, shape, dt_rank, clock_hz, sms, name, smi)
    torch.cuda.empty_cache()
    sum_k = lambda rs, k: sum(r["launches"].get(k, 0) for r in rs)
    launches = {k: {"tp_ssm_falcon_grad": sum_k(falcon, k),
                    "tp_ssm_hymba_rounds": sum_k(cells, k),
                    "tp_ssm_dense_reference": sum(
                        o["reference_launches"].get(k, 0) for o in outs)}
                for k in ("ssm_scan", "ssm_scan_bwd", "commit_grid")}
    emit("tp_ssm_done", seconds=max(o["rank_s"] for o in outs)
         + time.perf_counter() - t_phase, launches=launches)
    return {"launches": launches, "max_abs_err": err, "rows": rows}


def tp_reduced_rank(rank: int, archs, out: dict) -> None:
    """34(c), 35(c) on one rank: for each arch of ``archs`` at
    ``.reduced()`` width the dense reference rows (the ranks of
    ``TP_REDUCED_REF_NODES``; the others warm up meanwhile) and the cell
    on ``TP_REDUCED_MESH`` (``out["reduced " + arch]``), beside the
    references' seconds and kernel launches; every rank builds the mesh
    and waits at a barrier after each arch."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_sweep_mesh
    out.update(reference_s=0.0, reference_launches={})
    D, M = TP_REDUCED_MESH
    mesh = make_sweep_mesh(lanes=D, param_shards=M, ranks=range(D * M))
    for arch in archs:
        cfg = get_config(arch).reduced()
        t0 = time.perf_counter()
        ref = (tp_reference(rank, cfg, TP_REDUCED_REF_NODES,
                            TP_REDUCED_ROUNDS)
               if rank in TP_REDUCED_REF_NODES else {})
        if not ref:
            tp_warmup(cfg)
        out["reference_s"] += time.perf_counter() - t0
        for k, v in ref.pop("launches", {}).items():
            out["reference_launches"][k] = \
                out["reference_launches"].get(k, 0) + v
        dist.barrier()
        if mesh.coords is not None:
            t0 = time.perf_counter()
            out[f"reduced {arch}"] = dict(tp_cell(mesh, ref, cfg,
                                                  TP_REDUCED_ROUNDS),
                                          seconds=time.perf_counter() - t0)
        del ref
        torch.cuda.empty_cache()
        dist.barrier()


def check_reduced_cells(phase: str, kind: str, archs, outs: list,
                        want, name: str, smi: str) -> None:
    """34(c), 35(c) from the ranks' results ``outs``: each rank's cell
    emitted (``tp_{kind}_reduced_rank``), then held: every rank ran,
    ``info["tensor_parallel"]`` is ``want(arch)[0]`` (``[1]`` says what
    that layout is), live argument bytes = meta, the replicated leaves
    (``[2]`` names them) bitwise across each model group, RF206 clean,
    one loss, and both nodes' gathered state within ``TP_TOL`` of the
    dense round."""
    D, M = TP_REDUCED_MESH
    for o in outs:
        for arch in archs:
            c = o.get(f"reduced {arch}")
            if c is not None:
                emit(f"tp_{kind}_reduced_rank", arch=arch, rank=o["rank"],
                     backend=o["backend"],
                     **{k: v for k, v in c.items() if k != "info"},
                     model_axis=c["info"]["model_axis"], p=c["info"]["p"],
                     p_whole=c["info"]["p_whole"],
                     seq_parallel=c["info"]["seq_parallel"],
                     tensor_parallel=c["info"]["tensor_parallel"],
                     tol=TP_TOL, device=name, nvidia_smi=smi)
    for arch in archs:
        cells = [o[f"reduced {arch}"] for o in outs
                 if f"reduced {arch}" in o]
        tag = f"{phase}(c) {arch} ({D}, {M})"
        layout, what, replicated = want(arch)
        check(len(cells) == D * M, f"{tag}: every rank ran")
        for c in cells:
            info = c["info"]
            check(info["model_axis"] == "tensor" and info["seq_parallel"]
                  and info["tensor_parallel"] == dict(layout, ranks=M),
                  f"{tag}: tensor-parallel, sequence-parallel, {what} "
                  f"({info['tensor_parallel']})")
            check(c["live_argument_bytes"] == c["meta_argument_bytes"],
                  f"{tag}: the live argument bytes a rank "
                  f"({c['live_argument_bytes']}) equal the meta dry-run's "
                  f"({c['meta_argument_bytes']})")
            check(c["replicated_bitwise"] and c["replicated_elements"] > 0,
                  f"{tag}: the replicated leaves ({replicated}) bitwise "
                  "equal across the model group")
            check(c["audit"] == [], f"{tag}: the round audits clean (RF206)")
            check(len({tuple(x["losses"]) for x in cells}) == 1,
                  f"{tag}: every rank reports the same losses")
            if c["rel_err"]:
                check(all(v <= TP_TOL for v in c["rel_err"].values()),
                      f"{tag}: the gathered state within {TP_TOL} of the "
                      f"dense round ({c['rel_err']})")
        check(sum(1 for c in cells if c["rel_err"]) == D,
              f"{tag}: both nodes held to the dense round")


def tp_moe_rank() -> dict:
    """Phase 34 on one of ``TP_WORLD`` gloo ranks sharing cuda:0: the
    cells of ``TP_MOE_ARCHS`` at ``.reduced()`` width
    (``tp_reduced_rank``), then each arch's full-width gradient of
    ``TP_MOE_FULL`` on its model group; every rank builds every mesh and
    waits at a barrier after each."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    tp_reduced_rank(rank, TP_MOE_ARCHS, out)
    for arch, layers, m, _, _, _ in TP_MOE_FULL:
        gm = make_sweep_mesh(lanes=1, param_shards=m, ranks=range(m))
        if gm.coords is not None:
            t0 = time.perf_counter()
            out[arch] = dict(tp_grad(gm, tp_config(arch, layers),
                                     batch=TP_MOE_B, seq=TP_MOE_S,
                                     seq_parallel=False, remat=True),
                             seconds=time.perf_counter() - t0)
        dist.barrier()
    return out


def phase_tensor_parallel_moe(name: str, smi: str, outs: list) -> dict:
    """Phase 34: the MoE / MLA archs' ``model`` axis tensor-parallel on
    ranks sharing this card over gloo (see the module docstring), from
    the ranks' results ``outs`` (``tp_spawn``).  Returns the dense
    references' ``commit_grid`` launches."""
    t_phase = time.perf_counter()
    for o in outs:
        for arch in TP_MOE_ARCHS:
            if arch in o:
                emit("tp_moe_full_rank", rank=o["rank"], **o[arch],
                     tol=TP_TOL, device=name, nvidia_smi=smi)
    emit("tp_moe_ranks_done", seconds=max(o["rank_s"] for o in outs),
         reference_s=max(o["reference_s"] for o in outs))

    def want(arch):     # phi's reduced attention has 1 KV head: gathered
        mla = arch.startswith("deepseek")
        return ({"gathered": [] if mla else ["layers/attn"],
                 "vocab_parallel": True},
                "experts over model" + (", MLA's heads a rank" if mla
                                        else ""),
                "router, norms" + (", MLA's down-projections" if mla
                                   else ""))
    check_reduced_cells("34", "moe", TP_MOE_ARCHS, outs, want, name, smi)
    for arch, layers, m, experts, heads, params in TP_MOE_FULL:
        rs = [o[arch] for o in outs if arch in o]
        tag = f"34({'ab'[TP_MOE_ARCHS.index(arch)]}) {arch} ({layers} layers, M {m})"
        check(len(rs) == m and all(r["rel_err"] <= TP_TOL for r in rs),
              f"{tag}: the tensor-parallel gradient within {TP_TOL} of the "
              f"unsharded one ({[r['rel_err'] for r in rs]})")
        check(len({r["loss"] for r in rs}) == 1 and all(
            abs(r["loss"] - r["dense_loss"]) <= TP_TOL * abs(r["dense_loss"])
            for r in rs), f"{tag}: one loss a model group, the unsharded one")
        cfg = tp_config(arch)
        q = "q_b" if cfg.q_lora_rank else "wq"
        qk = cfg.hd + (cfg.qk_rope_dim if cfg.attention == "mla" else 0)
        local = lambda r: {
            "experts": r["shapes"]["layers/mlp/experts/wi"][-3],
            "heads": r["shapes"][f"layers/attn/{q}"][-1] // qk,
            "vocab_rows": r["shapes"]["embed"][0]}
        want = {"experts": experts, "heads": heads,
                "vocab_rows": cfg.vocab // m}
        check(all(r["p_whole"] == params and r["gathered"] == []
                  and r["vocab_parallel"] and r["expert_parallel"]
                  and local(r) == want for r in rs),
              f"{tag}: {params} parameters, experts, heads and vocab over "
              f"model ({want} a rank), no block gathered")
        check(len({r["routes_digest"] for r in rs}) == 1
              and len({tuple(r["drops"]) for r in rs}) == 1
              and all(r["routes_equal_unsharded"]
                      and r["route_calls"] == 2 * layers for r in rs),
              f"{tag}: every rank routes as the unsharded run (forward and "
              f"recomputed; drops {rs[0]['drops']})")
        check(max(u for r in rs for u in r["card_used_gb"])
              < TP_MOE_CARD_GB, f"{tag}: the card's memory in use stays "
              f"under {TP_MOE_CARD_GB} GB")
    emit("tp_moe_done", seconds=max(o["rank_s"] for o in outs)
         + time.perf_counter() - t_phase)
    return {"tp_moe_dense_reference": sum(
        o["reference_launches"].get("commit_grid", 0) for o in outs)}


def tp_front_rank() -> dict:
    """Phase 35 on one of ``TP_WORLD`` gloo ranks sharing cuda:0: the
    cells of ``TP_FRONT_ARCHS`` at ``.reduced()`` width
    (``tp_reduced_rank``), then each full-width gradient of
    ``TP_FRONT_FULL`` on its model group; every rank builds every mesh
    and waits at a barrier after each."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    tp_reduced_rank(rank, TP_FRONT_ARCHS, out)
    for arch, layers, m, *_ in TP_FRONT_FULL:
        gm = make_sweep_mesh(lanes=1, param_shards=m, ranks=range(m))
        if gm.coords is not None:
            t0 = time.perf_counter()
            out[f"{arch} M {m}"] = dict(tp_grad(
                gm, tp_config(arch, layers), batch=TP_FRONT_B,
                seq=TP_FRONT_S, seq_parallel=True, remat=True),
                seconds=time.perf_counter() - t0)
        dist.barrier()
    return out


def phase_tensor_parallel_front(name: str, smi: str, outs: list) -> dict:
    """Phase 35: the enc-dec and frontend archs' ``model`` axis
    tensor-parallel on ranks sharing this card over gloo (see the module
    docstring), from the ranks' results ``outs`` (``tp_spawn``).  Returns
    the dense references' ``commit_grid`` launches."""
    t_phase = time.perf_counter()
    full = [f"{a} M {m}" for a, _, m, *_ in TP_FRONT_FULL]
    for o in outs:
        for key in full:
            if key in o:
                emit("tp_front_full_rank", case=key, rank=o["rank"],
                     **o[key], tol=TP_TOL, device=name, nvidia_smi=smi)
    emit("tp_front_ranks_done", seconds=max(o["rank_s"] for o in outs),
         reference_s=max(o["reference_s"] for o in outs))

    def want(arch):     # reduced: 4 heads (pixtral 1 KV head: gathered),
        enc_dec = arch.startswith("whisper")   # vocab 512, 16 frames
        return ({"gathered": [] if enc_dec else ["layers/attn"],
                 "vocab_parallel": True,
                 **({"encoder_seq_parallel": True} if enc_dec else {})},
                "the encoder's stream sequence-parallel" if enc_dec
                else "the patch prefix",
                "norms, frontend_proj" + (", the MLPs' bo" if enc_dec
                                          else ""))
    check_reduced_cells("35", "front", TP_FRONT_ARCHS, outs, want, name,
                        smi)
    for (arch, layers, m, heads, enc_sp, vocab_par, params), key in zip(
            TP_FRONT_FULL, full):
        rs = [o[key] for o in outs if key in o]
        tag = f"35({'ab'[TP_FRONT_ARCHS.index(arch)]}) {arch} ({layers} " \
            f"layers, M {m})"
        check(len(rs) == m and all(r["rel_err"] <= TP_TOL for r in rs),
              f"{tag}: the tensor-parallel gradient within {TP_TOL} of the "
              f"unsharded one ({[r['rel_err'] for r in rs]})")
        check(len({r["loss"] for r in rs}) == 1 and all(
            abs(r["loss"] - r["dense_loss"]) <= TP_TOL * abs(r["dense_loss"])
            for r in rs), f"{tag}: one loss a model group, the unsharded one")
        cfg = tp_config(arch)
        blocks = (("layers/attn", "layers/cross", "enc_layers/attn")
                  if cfg.enc_dec else ("layers/attn",))
        gathered = sorted(blocks) if heads is None else []
        # a gathered block's local wq holds 1 / m of the columns, which
        # cut inside a head (whisper's 20 heads of 64 over 8: 2.5 heads)
        wq = cfg.n_heads * cfg.hd // m
        local = lambda r: {
            "wq_columns": {b: r["shapes"][f"{b}/wq"][-1] for b in blocks},
            "vocab_rows": r["shapes"]["embed"][0]}
        want = {"wq_columns": {b: wq for b in blocks},
                "vocab_rows": cfg.vocab // m if vocab_par else cfg.vocab}
        check(all(r["p_whole"] == params and r["gathered"] == gathered
                  and r["seq_parallel"] and r["enc_seq_parallel"] == enc_sp
                  and r["vocab_parallel"] == vocab_par and local(r) == want
                  for r in rs),
              f"{tag}: {params} parameters, "
              + (f"{heads} heads a rank" if heads else "the attention "
                 "gathered") + f", the encoder's stream "
              f"{'-' if enc_sp is None else enc_sp}, vocab-parallel "
              f"{vocab_par} ({want} a rank)")
        check(max(u for r in rs for u in r["card_used_gb"])
              < TP_MOE_CARD_GB, f"{tag}: the card's memory in use stays "
              f"under {TP_MOE_CARD_GB} GB")
    emit("tp_front_done", seconds=max(o["rank_s"] for o in outs)
         + time.perf_counter() - t_phase)
    return {"tp_front_dense_reference": sum(
        o["reference_launches"].get("commit_grid", 0) for o in outs)}


# --------------------------------------------------------------------- #
# phase 36: prefill and decode with the model axis tensor-parallel
# --------------------------------------------------------------------- #
def tp_serve_run(cfg, params, toks, fr, case: dict):
    """``prefill_cache`` of ``toks``' prompt (with the frames or patches
    ``fr``, None without a frontend) and the case's teacher-forced
    ``decode_step``s on ``params`` under the caller's layout: ``(logits of
    each, final cache, their MoE routes)``."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill_cache
    P = case["prompt"]

    def run():
        cache, lg = prefill_cache(cfg, params, toks[:, :P], case["max_len"],
                                  frontend=fr)
        logits = [lg]
        for i in range(case["steps"]):
            lg, cache = decode_step(cfg, params, cache,
                                    toks[:, P + i:P + i + 1])
            logits.append(lg)
        return torch.stack(logits), cache
    (logits, cache), routes = routed(run)
    return logits, cache, routes


def tp_serve_slots(cfg, params, toks, case: dict):
    """``TP_SERVE_SLOT_STEPS`` ``decode_step_slots`` on ``params`` under
    the caller's layout, from an empty cache whose rows start at
    ``TP_SERVE_SLOT_POS``, teacher-forced by the tokens after ``toks``'
    prompt: ``(logits of each, their MoE routes)``."""
    import torch
    from repro_torch.models.transformer import decode_step_slots, init_cache
    P, b = case["prompt"], toks.shape[0]
    cache = init_cache(cfg, params, b, case["max_len"])
    cache["slot_pos"] = cache["slot_pos"].expand(b, -1).clone()
    cache["idx"] = torch.tensor(TP_SERVE_SLOT_POS, dtype=torch.int32,
                                device=toks.device)

    def run():
        logits = []
        for i in range(TP_SERVE_SLOT_STEPS):
            lg, _ = decode_step_slots(cfg, params, cache,
                                      toks[:, P + i:P + i + 1])
            logits.append(lg)
        return torch.stack(logits)
    return routed(run)


def rows_routes(routes, rows: slice, batch: int, K: int) -> list:
    """:func:`routed`'s routes of a batch of ``batch`` rows (experts (1,
    batch·s, K), kept (1, batch·s·K)) cut to the tokens of ``rows``."""
    out = []
    for experts, kept in routes:
        s = experts.shape[1] // batch
        out.append((experts[:, rows.start * s:rows.stop * s],
                    kept[:, rows.start * s * K:rows.stop * s * K]))
    return out


def tp_serve_reference(cfg, full, toks, fr, case: dict, rows: slice) -> dict:
    """The unsharded run of :func:`tp_serve_run` of the case's whole
    batch ``toks`` on the whole tree ``full`` (and of
    :func:`tp_serve_slots` on the rows ``rows`` for a case with
    ``slots``), on the card: each step's logits, the final cache and a
    digest of the routes, cut to ``rows``; the whole batch's dropped
    choices, and how many of its choices' keep differ from routing each
    node's rows alone (the batch split as the case's mesh splits it)."""
    import torch
    from repro_torch.models import moe as moe_mod
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, routes = tp_serve_run(cfg, full, toks, fr, case)
    Bw, D = toks.shape[0], case["mesh"][0]
    cut = lambda t: (t[:, rows] if isinstance(t, torch.Tensor)
                     else {k: cut(v) for k, v in t.items()})
    K = cfg.moe_top_k
    differs = 0
    for experts, kept in routes:
        for n in range(D):
            (e, k), = rows_routes([(experts, kept)], slice(
                n * Bw // D, (n + 1) * Bw // D), Bw, K)
            alone = moe_mod._slots(cfg, e, moe_mod._capacity(
                cfg, e.shape[1]))[1]
            differs += int((alone != k).sum())
    out = {"logits": logits[:, rows],
           "cache": {k: v if k in ("idx", "slot_pos") else cut(v)
                     for k, v in cache.items()},
           "routes_digest": routes_digest(rows_routes(routes, rows, Bw, K)),
           "whole_drops": sum(int((~k).sum()) for _, k in routes),
           "per_node_differs": differs}
    if case["slots"]:
        lg, routes = tp_serve_slots(cfg, full, toks[rows], case)
        out.update(slots_logits=lg, slots_routes_digest=routes_digest(
            routes))
    torch.cuda.synchronize()
    return dict(out, seconds=time.perf_counter() - t0)


def tp_serve_case(mesh, case: dict, refs: dict) -> dict | None:
    """36 on one rank (None outside ``mesh``; every rank of the world
    takes part in the turns' barriers): the ranks of ``mesh`` in turn
    draw the case's tree on the card from seed 0 and keep their blocks,
    the group's model index 0 running the unsharded reference on the
    whole batch, cut to its node's rows (``refs``, kept for a later case
    of the same cut); then ``prefill_cache`` of the prompt
    (sequence-parallel) and its ``decode_step``s on the blocks, each
    timed, inside the data group's ``use_batch_group`` where the rows
    are split over nodes (an MoE layer routes the whole batch), with
    the collectives of the prefill and of one decode step (by group
    size), the kernel
    launches and scan shapes of the prefill, the logits and the cache
    gathered whole and, on model index 0, held to the reference.  A
    frontend arch's frames or patches are drawn after the tokens from
    the same seeded CUDA generator; an enc-dec arch's cross blocks also
    come from ``init_cache(..., frontend=)``, held to the prefill's."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.core.runtime_sharded import (all_gather_seq,
                                                  clear_collectives,
                                                  collective_stats,
                                                  record_collectives)
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _distinct_bytes
    from repro_torch.models import sharding as msh
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, param_shapes,
                                                prefill_cache)
    cfg = tp_config(case["arch"], case["layers"])
    inside = mesh.coords is not None
    P, C_len, steps = case["prompt"], case["max_len"], case["steps"]
    if inside:
        D, M = mesh.shape["data"], mesh.shape["model"]
        node, m = mesh.coords["data"], mesh.coords["model"]
        b = case["batch"] // D
        tp = specs.serving_layout(cfg, param_shapes(cfg), mesh,
                                  max_len=C_len,
                                  cache_seq_shard=case["seq_shard"],
                                  seq_parallel=case["seq_parallel"],
                                  dtype=torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(1)
        every = torch.randint(0, cfg.vocab, (case["batch"], P + steps),
                              generator=gen, device="cuda")
        fr_all = None if not cfg.frontend else torch.randn(
            (case["batch"], cfg.frontend_seq, cfg.frontend_dim),
            generator=gen, device="cuda")
        rows = slice(node * b, (node + 1) * b)
        toks = every[rows]
        fr = None if fr_all is None else fr_all[rows]
        bgroup = mesh.group("data") if D > 1 else None
        key = (case["arch"], cfg.n_layers, node, D, case["batch"], P,
               C_len, steps)
    out = {"case": case["case"]}
    t0 = time.perf_counter()
    for turn in range(TP_WORLD):
        dist.barrier()
        if not inside or turn != mesh.rank:
            continue
        full = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        local = msh.local_tree(full, tp)
        if m == 0 and key not in refs:
            refs[key] = tp_serve_reference(cfg, full, every, fr_all, case,
                                           rows)
            out["reference_s"] = refs[key]["seconds"]
        del full
        torch.cuda.empty_cache()
    dist.barrier()
    if not inside:
        return None
    out["turns_s"] = time.perf_counter() - t0
    shapes, captured = [], []

    def seen(*args, **kw):          # the prefill's scan calls
        shapes.append([*args[0].shape, args[2].shape[-1]])
        if not captured:
            captured.append([a.detach().cpu() for a in args[:6]])
        return scan_call(*args, **kw)
    scan_call = scan_ops.ssm_scan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    own, step_s = [], []

    def run():
        with msh.use_tensor_parallel(tp), msh.use_batch_group(bgroup):
            dispatch.clear()
            clear_collectives()
            t0 = time.perf_counter()
            cache, lg = prefill_cache(cfg, local, toks[:, :P], C_len,
                                      frontend=fr)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["prefill_collectives"] = collective_stats()
            out["prefill_launches"] = dispatch.stats()["by_kernel"]
            dispatch.clear()
            own.append(lg)
            for i in range(steps):
                clear_collectives()
                t0 = time.perf_counter()
                with record_collectives() as calls:
                    lg, cache = decode_step(cfg, local, cache,
                                            toks[:, P + i:P + i + 1])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if i == 0:
                    out["decode_collectives"] = collective_stats()
                    out["decode_groups"] = dict(collections.Counter(
                        f"{c['name']}@{c['group_size']}" for c in calls
                        if c["group_size"] > 1))
                own.append(lg)
            out["decode_launches"] = dispatch.stats()["by_kernel"]
        return cache
    try:
        scan_ops.ssm_scan = seen
        cache, routes = routed(run)
    finally:
        scan_ops.ssm_scan = scan_call
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(routes_digest=routes_digest(routes), route_calls=len(routes),
               drops=sum(int((~k).sum()) for _, k in routes))
    if case["slots"]:
        with msh.use_tensor_parallel(tp):
            slots_own, routes = tp_serve_slots(cfg, local, toks, case)
        out["slots_routes_digest"] = routes_digest(routes)
        slots_whole = (all_gather_seq(slots_own, tp.group, -1)
                       if tp.vocab_parallel else slots_own)
        del slots_own
    free, total = torch.cuda.mem_get_info()
    out["card_used_gb"] = (total - free) / 1e9
    cross = {k: cache[k] for k in ("cross_k", "cross_v") if k in cache}
    if cross:
        with msh.use_tensor_parallel(tp):
            init = init_cache(cfg, local, b, C_len, frontend=fr)
        out["init_cross_rel_err"] = max(
            float((init[k] - t).abs().max() / t.abs().max())
            for k, t in cross.items())
        out["init_cross_bitwise"] = all(torch.equal(init[k], t)
                                        for k, t in cross.items())
        del init
    own = torch.stack(own)
    whole_cache = specs.whole_cache(cfg, case["batch"], C_len,
                                    torch.float32)
    # the layers' leaves laid out over model, and those whole by design
    # (MLA's kr)
    leaves = lambda layers, whole: [t for path, t in msh._paths(layers)
                                    if (path[-1] in msh.WHOLE_LEAVES)
                                    == whole]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out.update(
        info=dict(model_axis="tensor", cache_layout=tp.cache_layout,
                  gathered=sorted("/".join(k) for k in tp.gathered),
                  vocab_parallel=tp.vocab_parallel,
                  seq_parallel=tp.seq_parallel),
        node=node, model=m, decode_s=step_s, scan_calls=shapes,
        logits_digest=hashlib.sha256(own.cpu().numpy().tobytes())
        .hexdigest(),
        cache_bytes=_distinct_bytes(leaves(cache["layers"], False)),
        kr_bytes=_distinct_bytes(leaves(cache["layers"], True)),
        cross_bytes=_distinct_bytes(specs.tensors_of(cross)),
        weight_bytes=_distinct_bytes(specs.tensors_of(local)),
        whole_weight_bytes=sum(t.numel() * 4 for t in specs.tensors_of(
            param_shapes(cfg))),
        whole_cache_bytes=nbytes(leaves(whole_cache["layers"], False)),
        whole_kr_bytes=nbytes(leaves(whole_cache["layers"], True)),
        whole_cross_bytes=nbytes(
            t for k, t in whole_cache.items()
            if k in ("cross_k", "cross_v")))
    if m == 0 and case["ssm"] and captured:
        out["scan_args"] = captured[0]
    whole = all_gather_seq(own, tp.group, -1) if tp.vocab_parallel else own
    gathered = msh.gather_cache(cache, tp)
    del own, cache, cross, local
    if m == 0:
        ref = refs[key]
        rel = lambda g, w: float((g - w).abs().max() / w.abs().max())
        out["logits_rel_err"] = max(rel(g, w) for g, w in
                                    zip(whole, ref["logits"]))
        # the ring's and SSM state's leaves and the cross caches
        leaves = lambda c: msh._paths({k: v for k, v in c.items()
                                       if k not in ("idx", "slot_pos")})
        out["cache_rel_err"] = {
            "/".join(path): rel(t, w) for (path, t), (_, w) in zip(
                leaves(gathered), leaves(ref["cache"]))}
        out["idx_equal"] = bool(torch.equal(gathered["idx"],
                                            ref["cache"]["idx"]))
        out["slot_pos_equal"] = bool(torch.equal(gathered["slot_pos"],
                                                 ref["cache"]["slot_pos"]))
        out["ref_routes_digest"] = ref["routes_digest"]
        out["whole_drops"] = ref["whole_drops"]
        out["per_node_differs"] = ref["per_node_differs"]
        if case["slots"]:
            out["slots_rel_err"] = max(rel(g, w) for g, w in zip(
                slots_whole, ref["slots_logits"]))
            out["ref_slots_routes_digest"] = ref["slots_routes_digest"]
    if case["slots"]:
        del slots_whole
    del whole, gathered
    torch.cuda.empty_cache()
    return out


def tp_serve_live(mesh) -> dict | None:
    """36(e) on one rank of ``mesh``: ``build_prefill`` and
    ``build_decode`` of full-width rfast-100m materialized on the card
    from seed 0 and run once, their argument bytes beside the meta
    case's on the described mesh."""
    import torch
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _distinct_bytes
    from repro_torch.launch.mesh import describe_mesh
    if mesh.coords is None:
        return None
    D, M = mesh.shape["data"], mesh.shape["model"]
    cfg = tp_config("rfast-100m")
    desc = describe_mesh((D, M), ("data", "model"), rank=mesh.rank)
    out = {}
    for name, build, kw in (("prefill", specs.build_prefill,
                             TP_SERVE_LIVE["prefill"]),
                            ("decode", specs.build_decode,
                             TP_SERVE_LIVE["decode"])):
        kw = dict(kw, dtype=torch.float32)
        fn, args = build(cfg, mesh, device="cuda", **kw)
        _, meta = build(cfg, desc, **kw)
        res = fn(*args)
        torch.cuda.synchronize()
        lg = res if name == "prefill" else res[0]
        out[name] = {"info": fn.info, "logits_shape": list(lg.shape),
                     "finite": bool(torch.isfinite(lg).all()),
                     "live_bytes": _distinct_bytes(specs.tensors_of(args)),
                     "meta_bytes": _distinct_bytes(specs.tensors_of(meta))}
        del fn, args, res, lg
    torch.cuda.empty_cache()
    return out


def tp_serve_rank() -> dict:
    """Phase 36 on one of ``TP_WORLD`` gloo ranks sharing cuda:0: each
    case of ``TP_SERVE`` on its mesh (the first ranks of the world;
    every rank builds every mesh and takes part in its turns), then
    36(e)'s live ``build_prefill`` / ``build_decode`` on its mesh.  The
    references stay on the rank that ran them until the phase ends."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    out = {"rank": rank, "cases": {}}
    refs: dict = {}
    for case in TP_SERVE:
        D, M = case["mesh"]
        mesh = make_sweep_mesh(lanes=D, param_shards=M, ranks=range(D * M))
        t0 = time.perf_counter()
        got = tp_serve_case(mesh, case, refs)
        if got is not None:
            out["cases"][case["case"]] = dict(
                got, seconds=time.perf_counter() - t0)
        dist.barrier()
    refs.clear()
    torch.cuda.empty_cache()
    D, M = TP_SERVE_LIVE["mesh"]
    mesh = make_sweep_mesh(lanes=D, param_shards=M, ranks=range(D * M))
    out["live"] = tp_serve_live(mesh)
    dist.barrier()
    return out


def phase_tensor_parallel_serve(name: str, smi: str, outs: list) -> dict:
    """Phase 36: prefill and decode with the ``model`` axis
    tensor-parallel on ranks sharing this card over gloo (see the module
    docstring), from the ranks' results ``outs`` (``tp_spawn``); then the
    first ``ssm_scan`` call of each SSM case's prefill on each node's
    model index 0, at a rank's channels, held to the plain twin.
    Returns the prefills' ``ssm_scan`` launches by case and the twin's
    largest error, overall and by case and shape."""
    t_phase = time.perf_counter()
    for o in outs:
        for key, c in o["cases"].items():
            emit("tp_serve_rank", rank=o["rank"],
                 **{k: v for k, v in c.items() if k != "scan_args"},
                 tol=TP_SERVE_TOL, device=name, nvidia_smi=smi)
        if o["live"] is not None:
            emit("tp_serve_live_rank", rank=o["rank"], **o["live"],
                 device=name, nvidia_smi=smi)
    emit("tp_serve_ranks_done", seconds=max(o["rank_s"] for o in outs))
    launches, scan_errs = {}, {}
    for case in TP_SERVE:
        key, (D, M) = case["case"], case["mesh"]
        rs = [o["cases"][key] for o in outs if key in o["cases"]]
        tag = f"36({key}) {case['arch']} ({case['layers'] or 'all'} " \
            f"layers, ({D}, {M}))"
        check(len(rs) == D * M, f"{tag}: every rank ran")
        layout = {"kv": case["kv"], "ssm": case["ssm"]}
        if case["cross"]:
            layout["cross"] = case["cross"]
        if case["latent"]:
            layout["latent"] = case["latent"]
        want_info = {"model_axis": "tensor", "cache_layout": layout,
                     "gathered": case["gathered"],
                     "vocab_parallel": case["vocab_parallel"],
                     "seq_parallel": case["seq_parallel"]}
        check(all(r["info"] == want_info for r in rs),
              f"{tag}: {want_info}")
        refs = [r for r in rs if r["model"] == 0]
        L = case["layers"]
        check(len(refs) == D and all(
            r["logits_rel_err"] <= TP_SERVE_TOL
            and max(r["cache_rel_err"].values()) <= TP_SERVE_TOL
            and r["idx_equal"] and r["slot_pos_equal"] for r in refs),
            f"{tag}: every step's logits and the gathered cache within "
            f"{TP_SERVE_TOL} of the unsharded run "
            f"({[(r['logits_rel_err'], r['cache_rel_err']) for r in refs]})")
        # a decode step's collectives over the model group and, the rows
        # split over nodes, an MoE layer's gather over the data group
        want_calls = dict(case["decode_calls"], **case["data_calls"])
        want_groups = {f"{k}@{M}": v for k, v in case["decode_calls"].items()}
        want_groups.update({f"{k}@{D}": v
                            for k, v in case["data_calls"].items()})
        check(not case["data_calls"] or D != M,
              f"{tag}: the data and model groups differ in size")
        for r in rs:
            got = {k: v["calls"] for k, v in
                   r["decode_collectives"]["by_name"].items()}
            check(got == want_calls and r["decode_groups"] == want_groups,
                  f"{tag}: a decode step's collectives {got} "
                  f"({r['decode_groups']} by group size) are "
                  f"{want_calls} ({want_groups})")
            check(r["cache_bytes"] * M == r["whole_cache_bytes"] // D
                  and r["cross_bytes"] * M == r["whole_cross_bytes"] // D
                  and r["kr_bytes"] == r["whole_kr_bytes"] // D
                  and r["weight_bytes"] < r["whole_weight_bytes"],
                  f"{tag}: a rank holds 1 / {M} of its rows' cache "
                  f"(ring or c {r['cache_bytes']} of "
                  f"{r['whole_cache_bytes']} B, cross {r['cross_bytes']} of "
                  f"{r['whole_cross_bytes']} B), all of its rows' kr "
                  f"({r['kr_bytes']} of {r['whole_kr_bytes']} B) and its "
                  "blocks of the weights")
            ref = next(q for q in refs if q["node"] == r["node"])
            if r["route_calls"]:
                check(r["route_calls"] == (1 + case["steps"]) * L
                      and r["routes_digest"] == ref["ref_routes_digest"],
                      f"{tag}: the prefill's and every step's MoE routes "
                      "and drops equal the unsharded run's")
            if case["slots"]:
                check(r["slots_routes_digest"]
                      == ref["ref_slots_routes_digest"],
                      f"{tag}: decode_step_slots' routes (each row alone) "
                      "equal the unsharded run's")
            if case["cross"]:
                check(r["init_cross_rel_err"] <= TP_SERVE_TOL,
                      f"{tag}: init_cache(frontend=)'s cross blocks within "
                      f"{TP_SERVE_TOL} of the prefill's "
                      f"({r['init_cross_rel_err']}, bitwise "
                      f"{r['init_cross_bitwise']})")
        if case["data_calls"]:
            # the nodes' rows keep and drop what the whole batch does
            drops = sum(r["drops"] for r in refs)
            emit("tp_serve_batch_routes", case=key,
                 whole_drops=refs[0]["whole_drops"],
                 node_drops=[r["drops"] for r in refs],
                 per_node_differs=refs[0]["per_node_differs"])
            check(all(r["whole_drops"] == drops for r in refs),
                  f"{tag}: the nodes' dropped choices ({drops}) are the "
                  f"whole batch's ({refs[0]['whole_drops']})")
        if case["slots"]:
            check(all(r["slots_rel_err"] <= TP_SERVE_TOL for r in refs),
                  f"{tag}: {TP_SERVE_SLOT_STEPS} decode_step_slots from "
                  f"positions {TP_SERVE_SLOT_POS} within {TP_SERVE_TOL} of "
                  f"the unsharded run ({[r['slots_rel_err'] for r in refs]})")
        if not case["vocab_parallel"]:
            check(len({r["logits_digest"] for r in rs}) == 1,
                  f"{tag}: the replicated head's logits bitwise equal "
                  "across the model group")
        if case["ssm"]:
            di = tp_config(case["arch"]).d_inner // M
            want = [[case["batch"] // D, case["prompt"], di, 16]] * L
            check(all(r["prefill_launches"].get("ssm_scan") == L
                      and r["scan_calls"] == want
                      and not r["decode_launches"].get("ssm_scan")
                      for r in rs),
                  f"{tag}: ssm_scan launched once a layer at the prefill "
                  f"at a rank's channels {want[0]}, never in a decode step")
        launches[f"tp_serve_{key}_prefill"] = sum(
            r["prefill_launches"].get("ssm_scan", 0) for r in rs)
        if not case["ssm"]:
            continue
        held_here = [r for r in refs if "scan_args" in r]
        check(len(held_here) == D, f"{tag}: the prefill's first ssm_scan "
              "call captured on every node's model index 0")
        for r in held_here:
            args = [a.cuda() for a in r["scan_args"]]
            shape = "x".join(map(str, [*args[0].shape, args[2].shape[-1]]))
            scan_errs[f"tp_serve_{key}_prefill_rank_{shape}"] = max(
                scan_errs.get(f"tp_serve_{key}_prefill_rank_{shape}", 0.0),
                compare_scan(args, SCAN_FP32_TOL, f"36({key}) ssm_scan at "
                             f"a rank's channels {shape}"))
            del args
    live = [o["live"] for o in outs if o["live"] is not None]
    D, M = TP_SERVE_LIVE["mesh"]
    check(len(live) == D * M and all(
        c[k]["info"]["model_axis"] == "tensor" and c[k]["finite"]
        and c[k]["live_bytes"] == c[k]["meta_bytes"] > 0
        for c in live for k in ("prefill", "decode")),
        f"36(e): build_prefill / build_decode on the card ({D}, {M}): "
        "tensor-parallel, finite logits, live argument bytes = meta")
    emit("tp_serve_done", seconds=max(o["rank_s"] for o in outs)
         + time.perf_counter() - t_phase, launches=launches,
         scan_max_abs_err=scan_errs)
    return {"launches": launches, "max_abs_err": max(scan_errs.values()),
            "err_by_shape": scan_errs}


def flash_inputs(B, H, KV, Sq, Sk, D, dtype, seed=0):
    """q (B,H,Sq,D), k, v (B,KV,Sk,D) and a cotangent of q's shape in
    ``dtype``, random on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return (a(B, H, Sq, D), a(B, KV, Sk, D), a(B, KV, Sk, D),
            a(B, H, Sq, D))


def max_err(got, want) -> float:
    return float((got.detach().float() - want.float()).abs().max())


def within(got, want, tol) -> bool:
    """Finite and within ``tol`` (atol = rtol) of ``want``."""
    import torch
    got = got.detach()
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=tol, atol=tol)


def held(got, want, tol, what) -> float:
    """Max abs error of ``got`` against ``want``; raises unless finite,
    of the same shape and dtype, and within ``tol`` (atol = rtol)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: layout {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(within(got, want, tol), f"{what}: finite and within {tol}")
    return max_err(got, want)


def flash_names(dtype):
    """The forward and the backward kernel that ``dtype`` runs."""
    from repro_torch.kernels.flash_attention.kernel import flash_names
    return flash_names(dtype)


def flash_work(B, H, KV, S, D, window, dtype):
    """Operations and bytes each flash kernel's function needs at the
    causal (B, H, KV, S, D) shape: the kernel package's counts
    (``flash_fwd_work``, ``flash_bwd_work``)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (flash_bwd_work,
                                                            flash_fwd_work)
    it = torch.tensor([], dtype=dtype).element_size()
    fwd_name, bwd_name = flash_names(dtype)
    return {fwd_name: flash_fwd_work(B, H, KV, S, S, D, True, window, it),
            bwd_name: flash_bwd_work(B, H, S, S, D, True, window, it)}


def bound(flops, nbytes, peak):
    """The least time in ms for ``flops`` at ``peak`` FLOP/s and
    ``nbytes`` at the HBM rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_entries(source):
    """ptxas's report for each kernel instantiation of ``source``'s build:
    registers, spill bytes and static shared memory."""
    import re
    from repro_torch.kernels import _build
    entries, cur = [], None
    for ln in _build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_store_bytes"], cur["spill_load_bytes"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return entries


def tc_report(kname, source, dims):
    """What the compiler made of one flash kernel: ptxas's registers and
    spill bytes for each instantiation, the dynamic shared memory one
    block asks for at each head dim of ``dims``, and the count of
    tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and of TMA
    loads (UTMALDG) in its SASS."""
    import ctypes
    from repro_torch.kernels import _build
    smem = getattr(_build.load(source), f"{kname}_smem")
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    text = _build.sass(source)
    return {"ptxas": ptxas_entries(source),
            "dynamic_smem_bytes": {f"D<={d}": smem(d) for d in dims},
            "sass": {op: text.count(op) for op in ("HGMMA", "HMMA",
                                                   "UTMALDG")}}


def flash_small_case(case, dtype, fwd_tol, grad_tol):
    """Both flash kernels of ``dtype`` against their plain twins on one
    small case: fp32 runs ``flash_fwd_3xtf32`` and ``flash_bwd_3xtf32``,
    bf16 ``flash_fwd_tc`` and ``flash_bwd_tc`` (dO in the inputs' dtype),
    held to ``flash_fwd_plain`` and ``flash_bwd_plain``.  Returns the
    errors and the launches."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rfast_update import dispatch
    B, H, KV, Sq, Sk, D, causal, window = case
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, bq=8, bk=8)
    dispatch.clear()
    o, lse = fk.flash_fwd(q, k, v, **kw)
    o_w, lse_w = fk.flash_fwd_plain(q, k, v, **kw)
    err = {fwd_name: held(o, o_w, fwd_tol, f"{fwd_name} {case}"),
           "lse": held(lse, lse_w, FLASH_FWD_TOL, f"{fwd_name} lse {case}")}
    rep = H // KV
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, _ = fk.flash_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    delta = (do.float() * o32).sum(-1)
    bkw = dict(kw, scale=D ** -0.5)
    got = fb.flash_bwd(q, kr, vr, do, lse_w, delta, **bkw)
    want = fb.flash_bwd_plain(q, kr, vr, do, lse_w, delta, **bkw)
    err[bwd_name] = max(held(g, w, grad_tol, f"{bwd_name} {n} {case}")
                        for g, w, n in zip(got, want, ("dq", "dk", "dv")))
    torch.cuda.synchronize()
    return err, dispatch.stats()["by_kernel"]


def flash_full_run(cfg, dtype, seed=0):
    """The flash path at one full width: the op forward, then forward +
    backward through the autograd function (k/v repeated to H heads in
    the graph; the cotangent in ``dtype``), each held against the plain
    twins.  Returns the errors by kernel and the launches each step
    made."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rfast_update import dispatch
    B, S, H, KV, D, window = (cfg[x] for x in ("B", "S", "H", "KV", "D",
                                                "window"))
    fwd_tol = FLASH_FWD_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    grad_tol = FLASH_GRAD_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, S, S, D, dtype, seed)
    steps = {}
    before = dict(dispatch.stats()["by_kernel"])
    delta_of = lambda: {n: c - before.get(n, 0) for n, c in
                        dispatch.stats()["by_kernel"].items()
                        if c != before.get(n, 0)}
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window,
                        impl="kernel").transpose(1, 2)
    torch.cuda.synchronize()
    steps["forward"] = delta_of()
    o_w, lse_w = fk.flash_fwd_plain(q, k, v, causal=True, window=window)
    err = {fwd_name: held(o, o_w, fwd_tol, "flash path forward")}
    del o, o_w

    before = dict(dispatch.stats()["by_kernel"])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    rep = H // KV
    out = fb.flash_attention_vjp(leaves[0],
                                 leaves[1].repeat_interleave(rep, 1),
                                 leaves[2].repeat_interleave(rep, 1),
                                 True, window)
    out.backward(do)
    torch.cuda.synchronize()
    steps["forward+backward"] = delta_of()
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, _ = fk.flash_fwd_plain(q, kr, vr, causal=True, window=window,
                                out_dtype=torch.float32)
    err[fwd_name] = max(err[fwd_name],
                        held(out, o32.to(dtype), fwd_tol,
                             "flash path forward (autograd)"))
    dof = do.float()
    delta = (dof * o32).sum(-1)
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    dq = fb.flash_dq_plain(q, kr, vr, dof, lse_w, delta, **kw)
    e_dq = held(leaves[0].grad, dq.to(dtype), grad_tol, "flash path dq")
    del dq
    dk, dv = fb.flash_dkv_plain(q, kr, vr, dof, lse_w, delta, **kw)
    group = lambda t: t.view(B, KV, rep, S, D).sum(2).to(dtype)
    e_dkv = max(held(leaves[1].grad, group(dk), grad_tol, "flash path dk"),
                held(leaves[2].grad, group(dv), grad_tol, "flash path dv"))
    err[bwd_name] = max(e_dq, e_dkv)
    return err, steps


def sdpa_calls(q, k, v, do, window, o_w, grads_w):
    """PyTorch's ``scaled_dot_product_attention`` on the flash op's inputs,
    each call forward (``fwd_ms``) and backward through autograd
    (``bwd_ms``), with its backend and its errors against the plain twins
    ``o_w`` and ``grads_w`` (dq, and dk, dv at H heads).  ``gqa``: k, v
    at KV heads with ``enable_gqa`` and the backend PyTorch picks; in
    fp32 also ``repeated_kv``: k, v repeated to H heads, the repeat made
    before the timed window, with the efficient backend forced (it takes
    no GQA).  Both use hymba's window as a boolean mask."""
    import contextlib
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, H, S, D = q.shape
    KV = k.shape[1]
    rep = H // KV
    fp32 = q.dtype == torch.float32
    fwd_tol = FLASH_FWD_TOL if fp32 else FLASH_BF16_TOL
    grad_tol = FLASH_GRAD_TOL if fp32 else FLASH_BF16_TOL
    if window:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        kw = dict(attn_mask=mask, is_causal=False)
    else:
        mask, kw = None, dict(is_causal=True)
    group = lambda t: t.view(B, KV, rep, S, D).sum(2)
    calls = {"gqa": ((q, k, v), dict(enable_gqa=True), None,
                     (grads_w[0], group(grads_w[1]), group(grads_w[2])))}
    if fp32:
        kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        calls["repeated_kv"] = ((q, kr, vr), {},
                                SDPBackend.EFFICIENT_ATTENTION, grads_w)
    out = {}
    for name, (ins, extra, forced, want) in calls.items():
        backend = forced.name if forced else SDPBackend(
            torch._fused_sdp_choice(*ins, mask, 0.0, kw["is_causal"],
                                    **extra)).name
        call = lambda *a: F.scaled_dot_product_attention(*a, **kw, **extra)
        with sdpa_kernel(forced) if forced else contextlib.nullcontext():
            o = call(*ins)
            row = dict(backend=backend, fwd_err=max_err(o, o_w),
                       fwd_ok=within(o, o_w, fwd_tol))
            del o
            row["fwd_ms"] = cuda_ms(lambda: call(*ins), reps=10)
            leaves = [t.detach().requires_grad_() for t in ins]
            o_lib = call(*leaves)
            grads = torch.autograd.grad(o_lib, leaves, do, retain_graph=True)
            row["bwd_err"] = max(max_err(g, w) for g, w in zip(grads, want))
            row["bwd_ok"] = all(within(g, w, grad_tol)
                                for g, w in zip(grads, want))
            del grads
            row["bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True), reps=10)
            del o_lib, leaves
        out[name] = row
        torch.cuda.empty_cache()
    return out


def flash_timing(name, cfg, dtype, smi, device):
    """CUDA-event medians of both flash kernels of ``dtype``, their plain
    twins and PyTorch's attention calls at one full width, beside the
    bound.  The kernels and the library read one cotangent, in
    ``dtype``.  ``library_ms`` is the fastest call within the tolerance
    (bf16: the one call)."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    B, S, H, KV, D, window = (cfg[x] for x in ("B", "S", "H", "KV", "D",
                                                "window"))
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, S, S, D, dtype, seed=2)
    kw = dict(causal=True, window=window)
    rows = {fwd_name: dict(
        ms=cuda_ms(lambda: fk.flash_fwd(q, k, v, **kw), reps=10),
        plain_ms=cuda_ms(lambda: fk.flash_fwd_plain(q, k, v, **kw), reps=5))}

    rep = H // KV
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, lse = fk.flash_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    delta = (do.float() * o32).sum(-1)
    bkw = dict(kw, scale=D ** -0.5)
    rows[bwd_name] = dict(
        ms=cuda_ms(lambda: fb.flash_bwd(q, kr, vr, do, lse, delta, **bkw),
                   reps=10),
        plain_ms=cuda_ms(lambda: fb.flash_bwd_plain(q, kr, vr, do, lse,
                                                    delta, **bkw), reps=5))
    grads_w = fb.flash_bwd_plain(q, kr, vr, do, lse, delta, **bkw)
    del kr, vr
    lib = sdpa_calls(q, k, v, do, window, o32.to(dtype), grads_w)
    del grads_w, o32
    for kname, key in ((fwd_name, "fwd"), (bwd_name, "bwd")):
        ok = {c: r for c, r in lib.items()
              if r[f"{key}_ok"] or dtype != torch.float32}
        best = min(ok, key=lambda c: ok[c][f"{key}_ms"]) if ok else None
        rows[kname].update(
            library_ms=ok[best][f"{key}_ms"] if best else None,
            library=None if best is None else
            f"scaled_dot_product_attention ({best}, {ok[best]['backend']})"
            + (" backward (dq, dk, dv)" if key == "bwd" else ""))
    work = flash_work(B, H, KV, S, D, window, dtype)
    # fp32 products run as 3xTF32 on the tensor cores
    peak = TF32X3_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    for kname, row in rows.items():
        flops, nbytes = work[kname]
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peak)
        if dtype == torch.float32:
            row["cuda_core_bound_ms"] = bound(flops, nbytes,
                                              FP32_FLOP_PER_S)[0]
        emit("flash_timing", kernel=kname, config=name, dtype=str(dtype),
             flops=flops, bytes=nbytes, bound_share=row["bound_ms"]
             / row["ms"], tflop_s=flops / row["ms"] / 1e9, sdpa=lib,
             device=device, nvidia_smi=smi, **row)
    return rows


# --------------------------------------------------------------------- #
# per-node kernels and the protocol round
# --------------------------------------------------------------------- #
def node_case(P, dtype, kw, ka, ko, *, seed=0, dev="cuda"):
    """Random operands of the full update on ``dev``: sources in
    ``dtype``, weights in [0, 1), 0/1 masks, device scalars."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    return dict(x=a(P), z=a(P), g_new=a(P), g_old=a(P), v_in=a(kw, P),
                w_in=u(kw), rho_in=a(ka, P), rho_buf=a(ka, P),
                mask=(u(ka) < 0.5).float(), rho_out=a(ko, P), a_out=u(ko),
                gamma=u(()) * 0.1, w_self=u(()), a_self=u(()))


def node_flops(kw, ka, ko, *, full) -> int:
    """fp32 operations per element of a node kernel (the kernel
    package's ``node_flops``)."""
    from repro_torch.kernels.rfast_update.kernel import node_flops
    return node_flops(kw, ka, ko, full=full)


COMMIT_KEYS = ("z", "g_new", "g_old", "rho_in", "rho_buf", "mask",
               "rho_out", "a_out", "a_self")


def compare_node(case, tol):
    """Both node kernels against their plain twins on ``case``: the max
    abs error of each; raises unless finite and within ``tol``."""
    from repro_torch.kernels.rfast_update import kernel as nk
    commit = {k: case[k] for k in COMMIT_KEYS}
    return {
        "rfast_update_node": max(
            held(g, w, tol, "rfast_update_node") for g, w in
            zip(nk.rfast_update_node(**case),
                nk.rfast_update_node_plain(**case))),
        "rfast_commit_node": max(
            held(g, w, tol, "rfast_commit_node") for g, w in
            zip(nk.rfast_commit_node(**commit),
                nk.rfast_commit_node_plain(**commit)))}


def round_grid_case(spec, p, *, seed=0, dev="cuda"):
    """``commit_grid``'s arguments at the protocol round's shape, wired
    by :func:`~repro_torch.core.protocol.round_commit_args` (the plan's
    node tables, B = N lanes, all delivered) over random (N, p) and
    (E_pad, p) state; and the bytes and operations the round needs of
    it: each distinct source row of a real edge read once, and the rows
    the round keeps (z' of every node, ρ_out'/ρ̃' of real edges) written
    once.  The pad slots' outputs, which the round drops, are not
    counted."""
    import numpy as np
    import torch
    from repro_torch.core.protocol import (ProtocolState, device_tables,
                                           round_commit_args)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda r: torch.randn(r, p, generator=g, device=dev)
    n, e = spec.n, spec.e_pad
    t = device_tables(spec)(torch.device(dev))
    state = ProtocolState(step=0, x=None, z=rows(n), g_prev=rows(n),
                          rho=rows(e), rho_buf=rows(e), mail_v=None, m=None)
    kw = round_commit_args(t, state, rows(n), t.ones)
    real_in = spec.in_a_epos[spec.in_a_val > 0]
    real_out = spec.out_a_epos[spec.out_a_val > 0]
    read = (3 * n + len(np.unique(np.concatenate([real_in, real_out])))
            + len(np.unique(real_in)))
    written = n + len(real_in) + len(real_out)
    nbytes = (read + written) * p * 4
    return kw, dict(B=n, ka=spec.ka, ko=spec.ko, Pf=p, bytes=nbytes,
                    rows_read=read, rows_written=written,
                    flops=p * (4 * n + 4 * len(real_in)
                               + 2 * len(real_out)))


def state_rel(a, b) -> float:
    """Largest norm-relative difference over x, z, ρ and ρ̃."""
    import torch
    return max(float(torch.linalg.vector_norm(u - w)
                     / torch.linalg.vector_norm(w).clamp_min(1e-30))
               for u, w in zip(a, b))


# --------------------------------------------------------------------- #
# engines, fleets and baselines
# --------------------------------------------------------------------- #
def field_rel(got, want) -> dict:
    """Per state field, the largest difference over the field's largest
    entry (``got``/``want``: RFASTStates or dicts of their fields)."""
    pick = lambda st, f: st[f] if isinstance(st, dict) else getattr(st, f)
    out = {}
    for f in STATE_FIELDS:
        a, b = pick(got, f).float(), pick(want, f).float().to(
            pick(got, f).device)
        out[f] = float((a - b).abs().max()
                       / b.abs().max().clamp_min(1e-30))
    return out


def state_rows(n: int, e_a: int, H: int, S: int = 1) -> int:
    """Rows of p floats an R-FAST state holds: x, v, z, g_prev per node,
    ρ and ρ̃ per A-edge, and H history rows of each (S lanes)."""
    return S * (4 * n + 2 * e_a + H * (n + e_a))


def lemma3_rel(st) -> float:
    import torch
    g = st.g_prev.sum(0)
    return float(torch.linalg.vector_norm(
        st.z.sum(0) + (st.rho - st.rho_buf).sum(0) - g)
        / torch.linalg.vector_norm(g).clamp_min(1e-30))


def time_to(metrics, target):
    """First virtual time at which the eval's mean loss is at most
    ``target`` (None if it never is)."""
    return next((m["t"] for m in metrics if m["loss"] <= target), None)


def logistic_eval(prob):
    """eval_fn of the engines and baselines: mean loss and accuracy of
    the node average (or of the single model)."""
    def ev(x, t):
        x = getattr(x, "x", x)
        xb = x.mean(0) if x.dim() == 2 else x
        return {"loss": float(prob.mean_loss(xb)),
                "acc": float(prob.accuracy(xb)), "t": t}
    return ev


def run_baseline(name, topo, prob, size, device, **kw):
    """One baseline runner on ``prob`` from x0 = 0: ``size`` rounds
    (sync) or events (async)."""
    import torch
    from repro_torch.core import baselines
    first = LOGISTIC_N if name == "ring_allreduce" else topo
    return getattr(baselines, f"run_{name}")(
        first, prob.grad_fn(), torch.zeros(prob.p, device=device),
        LOGISTIC_GAMMA, size, device=device, **kw)


# --------------------------------------------------------------------- #
# selective scan
# --------------------------------------------------------------------- #
def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def scan_inputs(Bsz, S, di, N, dtype, *, dt_rank=3, seed=0):
    """The scan's operands on the card as the model makes them: u
    N(0,1), dt = softplus(N(0,1) − 4.6), A = −(1..N) per channel, B and
    C column slices of one (B, S, dt_rank + 2N) projection, D N(0,1);
    u/dt/B/C in ``dtype``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = a(Bsz, S, di).to(dtype)
    dt = torch.nn.functional.softplus(a(Bsz, S, di) - 4.6).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device="cuda").expand(di, N).contiguous()
    proj = a(Bsz, S, dt_rank + 2 * N).to(dtype)
    return (u, dt, A, proj[..., dt_rank:dt_rank + N],
            proj[..., dt_rank + N:], a(di))


def scan_bound(Bsz, S, di, N, itemsize, clock_hz):
    """The least time for the scan: the largest of its bytes at
    3.35 TB/s (each input read once, each output written once), its fp32
    operations at 67 TFLOP/s (per (b, t, d, n) dt·A, the three of the h
    update, h·C and its share of the n sum; per (b, t, d) dt·u and the
    D·u multiply-add) and its exponentials (one per (b, t, d, n)) at the
    MUFU rate.  Returns (ms, "bytes" | "operations", terms)."""
    from repro_torch.kernels.ssm_scan.kernel import (ssm_scan_bytes,
                                                     ssm_scan_ops)
    nbytes = ssm_scan_bytes(Bsz, S, di, N, itemsize)
    flops, exps = ssm_scan_ops(Bsz, S, di, N)
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
             "mufu_ms": exps / (MUFU_PER_CLOCK_SM * H100_SMS * clock_hz)
             * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes_ms"] == ms else "operations", dict(
        terms, bytes=nbytes, flops=flops, exps=exps)


def scan_bwd_bound(Bsz, S, di, N, itemsize, n_ckpt, clock_hz):
    """The least time for the scan's backward, as :func:`scan_bound`: its
    bytes (u, dt, B, C, gy, the ``n_ckpt`` checkpoints a batch row, gh, A
    and D read; the six gradients written) at 3.35 TB/s, its fp32
    operations (per (b, t, d, n): the rerun's dt·A and h update, 4; the
    sweep's G = gy·C + carry, gy·h, G·dt·u, G·B into du, dA·h_{t−1}, its
    product with G, that into ddt and into dA, dA·G for the next step, 13;
    the d sums of dB and dC, 2; per (b, t, d): dt·u twice, du's and ddt's
    multiply-adds and dD's, 9) at 67 TFLOP/s, and its exponentials (one
    per (b, t, d, n): the rerun's, kept for the sweep) at the MUFU rate."""
    from repro_torch.kernels.ssm_scan.backward import (ssm_scan_bwd_bytes,
                                                       ssm_scan_bwd_ops)
    nbytes = ssm_scan_bwd_bytes(Bsz, S, di, N, itemsize, n_ckpt)
    flops, exps = ssm_scan_bwd_ops(Bsz, S, di, N)
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
             "mufu_ms": exps / (MUFU_PER_CLOCK_SM * H100_SMS * clock_hz)
             * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes_ms"] == ms else "operations", dict(
        terms, bytes=nbytes, flops=flops, exps=exps)


def scan_timing(sname, shape, dt_rank, clock_hz, sms, name, smi):
    """Phase 16's readings of both scan kernels at ``shape`` (B, S, di,
    N), fp32, B and C slices of a projection of ``dt_rank`` + 2N columns:
    the forward at the split ``scan_segments`` chooses (and unsplit),
    with checkpoints and as one call, the backward, their plain twins,
    both kernels through autograd, beside ``scan_bound`` /
    ``scan_bwd_bound``; emits one ``scan_timing`` line a kernel and
    returns their rows ``(forward, backward)`` (ms, plain_ms, bound_ms,
    bound_by)."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as scan_b
    from repro_torch.kernels.ssm_scan import kernel as scan_k
    from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn
    every = scan_k.CKPT_EVERY
    sargs = scan_inputs(*shape, torch.float32, dt_rank=dt_rank, seed=5)
    Bsz, S, di, N = shape
    long = S > 1024
    rule = scan_k.scan_segments(Bsz, S, di, N, sms)
    split = {nseg: graph_ms(lambda: scan_k.ssm_scan(*sargs,
                                                    segments=nseg))
             for nseg in sorted({1, rule})}
    row = dict(
        ms=split[rule],
        plain_ms=cuda_ms(lambda: scan_k.ssm_scan_plain(*sargs),
                         reps=2 if long else 5, warmup=1 if long else 2))
    row["bound_ms"], row["bound_by"], terms = scan_bound(*shape, 4,
                                                         clock_hz)
    more = {
        # one call as a caller pays it, the wrapper's host work included
        "call_ms": cuda_ms(lambda: scan_k.ssm_scan(*sargs), reps=20),
        # as the autograd function runs it: with the checkpoints
        "ckpt_ms": graph_ms(lambda: scan_k.ssm_scan(
            *sargs, ckpt_every=every)),
        "segments": rule, "ms_by_segments": split}
    _, _, ckpt = scan_k.ssm_scan(*sargs, ckpt_every=every)
    gg = torch.Generator(device="cuda").manual_seed(6)
    bargs = (*sargs, torch.randn(Bsz, S, di, generator=gg, device="cuda"),
             torch.randn(Bsz, di, N, generator=gg, device="cuda"), ckpt)
    n_ck = scan_k.n_checkpoints(S, every)
    brow = dict(
        ms=graph_ms(lambda: scan_b.ssm_scan_bwd(*bargs,
                                                ckpt_every=every)),
        # the twin once at the op widths (two Python loops over S)
        plain_ms=cuda_ms(lambda: scan_b.ssm_scan_bwd_plain(
            *bargs, ckpt_every=every), reps=1 if long else 3,
            warmup=0 if long else 1))
    # the gradient's own bound, its checkpoints at the spacing the least
    # work needs; and as the kernel reads them, at CKPT_EVERY
    brow["bound_ms"], brow["bound_by"], bterms = scan_bwd_bound(
        *shape, 4, scan_k.n_checkpoints(S, SCAN_BOUND_CKPT_EVERY),
        clock_hz)
    at_every, _, every_terms = scan_bwd_bound(*shape, 4, n_ck, clock_hz)
    # one SSM layer's scan in a gradient: both kernels through autograd
    # (at hymba's op width the forward splits: the shape a train at
    # --batch-per-node 1 --seq 4096 gives the scan)
    leaves = [t.detach().requires_grad_() for t in sargs]
    more["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        SelectiveScanFn.apply(*leaves)[0].sum(), leaves),
        reps=5 if long else 10)
    del leaves
    emit("scan_timing", kernel="ssm_scan", shape=sname, **more,
         case=dict(zip(("B", "S", "di", "N"), shape)), dtype="float32",
         bound_share=row["bound_ms"] / row["ms"],
         achieved_gb_s=terms["bytes"] / row["ms"] / 1e6,
         sm_clock_max_mhz=clock_hz / 1e6, library_ms=None,
         device=name, nvidia_smi=smi, **row, **terms)
    emit("scan_timing", kernel="ssm_scan_bwd", shape=sname,
         case=dict(zip(("B", "S", "di", "N"), shape)), dtype="float32",
         ckpt_every=every, bound_ckpt_every=SCAN_BOUND_CKPT_EVERY,
         bound_share=brow["bound_ms"] / brow["ms"],
         bound_ms_at_ckpt_every=at_every,
         bound_share_at_ckpt_every=at_every / brow["ms"],
         bytes_at_ckpt_every=every_terms["bytes"],
         achieved_gb_s=every_terms["bytes"] / brow["ms"] / 1e6,
         library_ms=None, device=name, nvidia_smi=smi, **brow, **bterms)
    del sargs, bargs, ckpt
    return row, brow


def compare_scan(args, tol, what, segments=(1, 3), fwd=None) -> float:
    """The forward kernel (``fwd``, by default the checkout's
    ``ssm_scan``) against its plain twin on ``args``, unsplit and split:
    the max abs error over y, h_last and the checkpoints at the autograd
    function's spacing (y and h_last where ``fwd`` returns no
    checkpoints); raises unless finite and within ``tol``."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    fwd = fwd or sk.ssm_scan
    want = sk.ssm_scan_plain(*args, ckpt_every=sk.CKPT_EVERY)
    return max(held(g, w, tol, f"{what} {n} ({nseg} segments)")
               for nseg in segments
               for g, w, n in zip(
                   fwd(*args, ckpt_every=sk.CKPT_EVERY, segments=nseg),
                   want, ("y", "h_last", "checkpoints")))


def compare_scan_bwd(args, tol, what, seed=0, bwd=None):
    """The backward kernel (``bwd``, by default the checkout's
    ``ssm_scan_bwd``) against its plain twin on ``args`` and random
    cotangents, with and without a gradient of h_last: returns (the
    largest error relative to each gradient's largest entry, the largest
    absolute error); raises unless finite and within ``tol`` relative."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as sb
    from repro_torch.kernels.ssm_scan import kernel as sk
    bwd = bwd or sb.ssm_scan_bwd
    Bsz, S, di = args[0].shape
    N = args[2].shape[1]
    _, _, ckpt = sk.ssm_scan_plain(*args, ckpt_every=sk.CKPT_EVERY)
    g = torch.Generator(device="cuda").manual_seed(seed)
    gy = torch.randn(Bsz, S, di, generator=g, device="cuda")
    gh = torch.randn(Bsz, di, N, generator=g, device="cuda")
    rel = absolute = 0.0
    for h in (gh, None):
        got = bwd(*args, gy, h, ckpt, ckpt_every=sk.CKPT_EVERY)
        want = sb.ssm_scan_bwd_plain(*args, gy, h, ckpt,
                                     ckpt_every=sk.CKPT_EVERY)
        for name, a, w, x in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got,
                                 want, args):
            check(a.dtype == w.dtype == x.dtype,
                  f"{what} {name}: in its input's dtype {x.dtype}")
            scale = max(1.0, float(w.float().abs().max()))
            absolute = max(absolute, float((a.float() - w.float()).abs()
                                           .max()))
            err = held(a.float() / scale, w.float() / scale, tol,
                       f"{what} {name} ({'with' if h is not None else 'no'}"
                       f" gh)")
            rel = max(rel, err)
    return rel, absolute


# --------------------------------------------------------------------- #
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import backward as fa_bwd
    from repro_torch.kernels.flash_attention import kernel as fa_fwd
    from repro_torch.kernels.rfast_update import dispatch, grid
    from repro_torch.kernels.rfast_update import kernel as node_k
    from repro_torch.kernels.ssm_scan import backward as scan_b
    from repro_torch.kernels.ssm_scan import kernel as scan_k
    sources = [grid.KERNEL_SOURCE, fa_fwd.KERNEL_SOURCE, fa_bwd.KERNEL_SOURCE,
               fa_fwd.TC_SOURCE, fa_bwd.TC_SOURCE, node_k.KERNEL_SOURCE,
               scan_k.KERNEL_SOURCE, scan_b.KERNEL_SOURCE]

    # 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(cap == (9, 0), f"compute capability 9.0, got {cap}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for src in sources
             for ln in _build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=build_s, libraries=[str(p.relative_to(ROOT))
                                              if p.is_relative_to(ROOT)
                                              else str(p)
                                              for p in libs.values()],
         ptxas=ptxas)
    # the flash kernels: registers, spills and shared memory per
    # instantiation, and tensor-core instructions in the SASS (HGMMA:
    # wgmma; HMMA: mma.sync); the bf16 forward's tiles arrive by TMA
    for kname, src, dims in (
            ("flash_fwd_3xtf32", fa_fwd.KERNEL_SOURCE, (32, 64, 128)),
            ("flash_bwd_3xtf32", fa_bwd.KERNEL_SOURCE, (32, 64, 128)),
            ("flash_fwd_tc", fa_fwd.TC_SOURCE, (64, 128)),
            ("flash_bwd_tc", fa_bwd.TC_SOURCE, (64, 128))):
        report = tc_report(kname, src, dims)
        emit("build_tc", kernel=kname, **report)
        ops = report["sass"]
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0
              if kname == "flash_fwd_tc" else ops["HGMMA"] + ops["HMMA"] > 0,
              f"{kname} runs on the tensor cores (and the bf16 forward's "
              f"tiles arrive by TMA): {ops}")
    # the scan's two kernels: registers, spills, static shared memory per
    # instantiation; the backward's dynamic shared memory per block
    for kname, src in (("ssm_scan", scan_k.KERNEL_SOURCE),
                       ("ssm_scan_bwd", scan_b.KERNEL_SOURCE)):
        entries = ptxas_entries(src)
        emit("build_scan", kernel=kname, ptxas=entries,
             **({"dynamic_smem_bytes": {
                 f"T={scan_k.CKPT_EVERY}, N={n}": scan_b.bwd_smem_bytes(
                     scan_k.CKPT_EVERY, n) for n in (4, 8, 16)}}
                if kname == "ssm_scan_bwd" else {}))
        check(len(entries) == 6 and all(
            e.get("spill_store_bytes", 0) == 0 for e in entries),
            f"{kname}: six instantiations (fp32, bf16 x 1, 2, 4 lanes), "
            f"none spilling: {entries}")

    # 3. kernels vs plain --------------------------------------------------
    for P in (37, 100_001):
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16,
                                                    BF16_TOL)):
            for clamp in (False, True):
                err = compare_grid(grid_case(P, dt, clamp=clamp), tol)
                emit("kernels", kernel="commit_grid", Pf=P, dtype=str(dt),
                     clamp=clamp, max_abs_err=err, tol=tol)
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import make_ravel_spec
    from repro_torch.models.transformer import init_params
    cfg = get_config("rfast-100m")
    p_run = make_ravel_spec(init_params(cfg, torch.Generator()
                                        .manual_seed(0)), pad_to=128).p
    kw, shape = main_path_case(p_run)
    main_err = compare_grid(kw, FP32_TOL)
    emit("kernels", kernel="commit_grid", main_path=True, dtype="float32",
         max_abs_err=main_err, tol=FP32_TOL,
         **{k: v for k, v in shape.items() if k not in ("bytes", "flops")})
    del kw
    torch.cuda.empty_cache()

    # 4. train at full width -----------------------------------------------
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.stats()["by_kernel"]
    emit("train", p=res["p"], events=res["events"], waves=res["waves"],
         loss_init=res["losses"][0], loss_final=res["losses"][-1],
         losses=res["losses"], packed_state_gb=res["packed_bytes"] / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         wall_s=wall, launches=launches, lemma3_rel=res["mass_rel"],
         device=name, nvidia_smi=smi)
    check(all(math.isfinite(v) for v in res["losses"]), "finite losses")
    check(res["waves"] > 0 and launches.get("commit_grid", 0)
          == res["waves"], "one commit_grid launch per wave")
    check(res["mass_rel"] <= 1e-4, "Lemma-3 residual <= 1e-4")
    torch.cuda.empty_cache()

    # 5. backends: kernel vs plain at two layers -----------------------------
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.simulator import run_rfast
    from repro_torch.core.topology import get_topology
    from repro_torch.data.objectives import make_lm_problem
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    prob = make_lm_problem(cfg2, 4, batch_per_node=4, seq_len=128, seed=0,
                           device="cuda")
    topo = get_topology("binary_tree", 4)
    sched = get_scenario("uniform", 4).realize(topo, 16, seed=0).schedule
    finals, backend_launches = {}, {}
    for impl in ("kernel", "plain"):
        dispatch.clear()
        st, _ = run_rfast(topo, sched, prob, prob.x0_flat, 3e-3, seed=0,
                          impl=impl, device="cuda")
        backend_launches[impl] = dispatch.launches("commit_grid")
        finals[impl] = (st.x.clone(), st.z.clone())
        del st
        torch.cuda.empty_cache()
    rel = [float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))
           for a, b in zip(finals["kernel"], finals["plain"])]
    emit("backends", n_layers=2, p=prob.p, x_rel=rel[0], z_rel=rel[1],
         tol=1e-5, commit_grid_launches=backend_launches)
    check(max(rel) <= 1e-5, "kernel and plain backends agree to 1e-5")
    check(backend_launches["kernel"] > 0 and backend_launches["plain"] == 0,
          "only the kernel backend launches commit_grid")
    del finals, prob
    torch.cuda.empty_cache()

    # 6. timing at the main path's shape --------------------------------------
    kw, shape = main_path_case(p_run, seed=1)
    ms = cuda_ms(lambda: grid.commit_grid(**kw), reps=10)
    plain_ms = cuda_ms(lambda: grid.commit_grid_plain(**kw), reps=5)
    t_bytes = shape["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = shape["flops"] / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    formula = grid.commit_grid_bytes(shape["B"], shape["ka"], shape["ko"],
                                     shape["Pf"], 4)
    emit("timing", kernel="commit_grid", ms=ms, plain_ms=plain_ms,
         bytes=shape["bytes"], formula_bytes=formula, flops=shape["flops"],
         bound_ms=bound_ms, bound_by=bound_by,
         achieved_gb_s=shape["bytes"] / ms / 1e6,
         bound_share=bound_ms / ms, library_ms=None, device=name,
         nvidia_smi=smi, **{k: shape[k] for k in ("B", "ka", "ko", "Pf")})
    del kw
    torch.cuda.empty_cache()

    # 7. flash kernels vs plain at small odd cases --------------------------
    for case in FLASH_SMALL + FLASH_SMALL_BF16:
        for dt, fwd_tol, grad_tol in ((torch.float32, FLASH_FWD_TOL,
                                       FLASH_GRAD_TOL),
                                      (torch.bfloat16, FLASH_BF16_TOL,
                                       FLASH_BF16_TOL)):
            if dt == torch.float32 and case in FLASH_SMALL_BF16:
                continue
            err, small_launches = flash_small_case(case, dt, fwd_tol,
                                                   grad_tol)
            emit("flash_kernels", case=dict(zip(
                ("B", "H", "KV", "Sq", "Sk", "D", "causal", "window"),
                case)), dtype=str(dt), max_abs_err=err, fwd_tol=fwd_tol,
                grad_tol=grad_tol, launches=small_launches)
            fwd_name, bwd_name = flash_names(dt)
            check(small_launches == {fwd_name: 1, bwd_name: 1},
                  f"one launch of each {dt} flash kernel at {case}: "
                  f"{small_launches}")

    # 8. the flash path at full attention width -----------------------------
    dispatch.clear()
    flash_err, runs = {}, {}
    for cfg_name, cfg in FLASH_FULL:
        for dt in (torch.float32, torch.bfloat16):
            err, steps = flash_full_run(cfg, dt)
            runs[dt] = runs.get(dt, 0) + 1
            emit("flash_path", config=cfg_name, dtype=str(dt), **cfg,
                 max_abs_err=err, launches=steps)
            fwd_name, bwd_name = flash_names(dt)
            check(steps == {"forward": {fwd_name: 1},
                            "forward+backward": {fwd_name: 1,
                                                 bwd_name: 1}},
                  f"flash launches per step at {cfg_name} {dt}: {steps}")
            if cfg_name == "llama3-8b":
                flash_err.update(err)
            torch.cuda.empty_cache()
    flash_launches = dispatch.stats()["by_kernel"]
    emit("flash_path", runs={str(d): n for d, n in runs.items()},
         launches=flash_launches)
    n32, n16 = runs[torch.float32], runs[torch.bfloat16]
    check(flash_launches == {"flash_fwd_3xtf32": 2 * n32,
                             "flash_bwd_3xtf32": n32,
                             "flash_fwd_tc": 2 * n16,
                             "flash_bwd_tc": n16}, "flash path launches")

    # 9. flash timing at the llama3-8b and hymba-1.5b widths ----------------
    flash_rows = {}
    for cfg_name, cfg in FLASH_FULL[:2]:
        for dt in (torch.float32, torch.bfloat16):
            rows = flash_timing(cfg_name, cfg, dt, smi, name)
            if cfg_name == "llama3-8b":
                flash_rows.update(rows)
            torch.cuda.empty_cache()

    # 10. node kernels vs plain, then their ops at full width --------------
    for P in (1, 37, 4097, 100_001):
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16,
                                                    BF16_TOL)):
            for slots in NODE_SLOTS:
                err = compare_node(node_case(P, dt, *slots), tol)
                emit("node_kernels", P=P, dtype=str(dt),
                     kw_ka_ko=list(slots), max_abs_err=err, tol=tol)
    node_case_full = node_case(p_run, torch.float32, *NODE_SLOTS[0], seed=1)
    node_err = compare_node(node_case_full, FP32_TOL)
    emit("node_kernels", P=p_run, dtype="float32",
         kw_ka_ko=list(NODE_SLOTS[0]), max_abs_err=node_err, tol=FP32_TOL)
    from repro_torch.kernels.rfast_update import ops as node_ops
    dispatch.clear()
    full = node_ops.rfast_update(**node_case_full, impl="kernel")
    commit = node_ops.rfast_commit(
        **{k: node_case_full[k] for k in COMMIT_KEYS}, impl="kernel",
        oracle=True)
    torch.cuda.synchronize()
    node_op_launches = dispatch.stats()["by_kernel"]
    op_err = max(held(g, w, FP32_TOL, "ops.rfast_update") for g, w in zip(
        full + commit, node_k.rfast_update_node_plain(**node_case_full)
        + node_k.rfast_commit_node_plain(
            **{k: node_case_full[k] for k in COMMIT_KEYS})))
    emit("node_ops", P=p_run, launches=node_op_launches, max_abs_err=op_err)
    check(node_op_launches == {"rfast_update_node": 1,
                               "rfast_commit_node": 1},
          f"one launch per node op: {node_op_launches}")
    # its ten full-width rows go before the train: phase 13 makes them anew
    del full, commit, node_case_full
    torch.cuda.empty_cache()

    # 11. sync train at full width -------------------------------------------
    sync_launches = {}
    for tag, extra in SYNC_RUNS:
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        sres = train.main(SYNC_ARGS + extra)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        sync_launches[tag] = dispatch.stats()["by_kernel"]
        emit("sync_train", run=tag, args=extra, p=sres["p"],
             rounds=sres["rounds"], losses=sres["losses"],
             state_gb=sres["state_bytes"] / 1e9,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             memory_gb={k: {m: b / 1e9 for m, b in v.items()}
                        for k, v in sres["memory"].items()},
             resident_before_gb=resident / 1e9,
             wall_s=swall, launches=sync_launches[tag],
             lemma3_rel=sres["mass_rel"], device=name, nvidia_smi=smi)
        check(all(math.isfinite(v) for v in sres["losses"]),
              f"{tag}: finite losses")
        check(sync_launches[tag] == {"commit_grid": sres["rounds"]},
              f"{tag}: one commit_grid launch per round, no other: "
              f"{sync_launches[tag]}")
        check(sres["mass_rel"] <= 1e-4, f"{tag}: Lemma-3 residual <= 1e-4")
        torch.cuda.empty_cache()

    # 12. round routes at two layers of full width ---------------------------
    from repro_torch.core.protocol import ProtocolState
    from repro_torch.core.runtime import make_rfast_round
    import numpy as np
    plan4, st0, grad_fn, batches, _ = train.sync_setup(
        cfg2, 4, "binary_tree", batch_per_node=4, seq=128, seed=0,
        device="cuda", robust=True, momentum=0.9)
    mrng = np.random.default_rng(1)
    masks = [torch.from_numpy((mrng.uniform(size=plan4.e_pad) >= 0.3)
                              .astype(np.float32)).cuda() for _ in range(4)]
    route_finals, route_launches = {}, {}
    for rname, impl, oracle in (("kernel", "kernel", False),
                                ("oracle", "kernel", True),
                                ("plain", "plain", False)):
        st = ProtocolState(st0.step, *(None if t is None else t.clone()
                                       for t in st0[1:]))
        rf = make_rfast_round(plan4, grad_fn, gamma=3e-3, robust=True,
                              momentum=0.9, impl=impl, oracle=oracle,
                              donate=True)
        dispatch.clear()
        for r, mk in enumerate(masks):
            st, _ = rf(st, batches(r), None, mk)
        torch.cuda.synchronize()
        route_launches[rname] = dispatch.stats()["by_kernel"]
        route_finals[rname] = (st.x, st.z, st.rho, st.rho_buf)
        del st
        torch.cuda.empty_cache()
    route_rel = {r: state_rel(route_finals[r], route_finals["plain"])
                 for r in ("kernel", "oracle")}
    emit("round_routes", n_layers=2, p=st0.x.shape[1], rounds=len(masks),
         rel_vs_plain=route_rel, tol=ROUTE_TOL, launches=route_launches)
    check(max(route_rel.values()) <= ROUTE_TOL,
          f"round routes agree to {ROUTE_TOL}")
    check(route_launches == {
        "kernel": {"commit_grid": len(masks)},
        "oracle": {"rfast_commit_node": 4 * len(masks)},
        "plain": {}}, f"round route launches: {route_launches}")
    del route_finals, st0
    torch.cuda.empty_cache()

    # 13. node kernel timing at full width, commit_grid at the round shape --
    node_case_full = node_case(p_run, torch.float32, *NODE_SLOTS[0], seed=1)
    commit_full = {k: node_case_full[k] for k in COMMIT_KEYS}
    node_rows = {
        "rfast_update_node": dict(
            ms=cuda_ms(lambda: node_k.rfast_update_node(**node_case_full),
                       reps=10),
            plain_ms=cuda_ms(lambda: node_k.rfast_update_node_plain(
                **node_case_full), reps=5),
            nbytes=node_k.rfast_update_node_bytes(*NODE_SLOTS[0], p_run, 4),
            flops=p_run * node_flops(*NODE_SLOTS[0], full=True)),
        "rfast_commit_node": dict(
            ms=cuda_ms(lambda: node_k.rfast_commit_node(**commit_full),
                       reps=10),
            plain_ms=cuda_ms(lambda: node_k.rfast_commit_node_plain(
                **commit_full), reps=5),
            nbytes=node_k.rfast_commit_node_bytes(*NODE_SLOTS[0][1:], p_run,
                                                  4),
            flops=p_run * node_flops(*NODE_SLOTS[0], full=False))}
    for kname, row in node_rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["flops"], row["nbytes"],
                                                 FP32_FLOP_PER_S)
        emit("node_timing", kernel=kname, P=p_run, kw_ka_ko=list(
            NODE_SLOTS[0]), bytes=row["nbytes"], flops=row["flops"],
            achieved_gb_s=row["nbytes"] / row["ms"] / 1e6,
            bound_share=row["bound_ms"] / row["ms"], library_ms=None,
            device=name, nvidia_smi=smi,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")})
    del node_case_full, commit_full
    torch.cuda.empty_cache()
    kw, rshape = round_grid_case(plan4, p_run)
    round_ms = cuda_ms(lambda: grid.commit_grid(**kw), reps=10)
    round_plain_ms = cuda_ms(lambda: grid.commit_grid_plain(**kw), reps=5)
    round_bound, round_by = bound(rshape["flops"], rshape["bytes"],
                                  FP32_FLOP_PER_S)
    emit("round_timing", kernel="commit_grid", ms=round_ms,
         plain_ms=round_plain_ms, bytes=rshape["bytes"],
         formula_bytes=grid.commit_grid_bytes(rshape["B"], rshape["ka"],
                                              rshape["ko"], p_run, 4),
         flops=rshape["flops"], bound_ms=round_bound, bound_by=round_by,
         achieved_gb_s=rshape["bytes"] / round_ms / 1e6,
         bound_share=round_bound / round_ms, library_ms=None, device=name,
         nvidia_smi=smi, **{k: rshape[k] for k in (
             "B", "ka", "ko", "Pf", "rows_read", "rows_written")})
    del kw
    torch.cuda.empty_cache()

    # 14. the scan kernels vs their plain twins, and the autograd function
    from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    for case in SCAN_SMALL + [SCAN_TRAIN[1]]:
        for dt, tol in ((torch.float32, SCAN_FP32_TOL),
                        (torch.bfloat16, SCAN_BF16_TOL)):
            sargs = scan_inputs(*case, dt)
            err = compare_scan(sargs, tol, f"ssm_scan {case}")
            rel, _ = compare_scan_bwd(sargs, tol, f"ssm_scan_bwd {case}")
            emit("scan_kernel", case=dict(zip(("B", "S", "di", "N"), case)),
                 dtype=str(dt), max_abs_err=err, bwd_max_rel_err=rel,
                 tol=tol)
    sargs = scan_inputs(*SCAN_TRAIN[1], torch.float32, dt_rank=SCAN_TRAIN[2],
                        seed=1)
    scan_err = compare_scan(sargs, SCAN_FP32_TOL,
                            "ssm_scan at the train shape")
    scan_bwd_rel, scan_bwd_err = compare_scan_bwd(
        sargs, SCAN_FP32_TOL, "ssm_scan_bwd at the train shape", seed=4)
    del sargs
    leaves = [t.detach().requires_grad_() for t in scan_inputs(
        *SCAN_TRAIN[1], torch.float32, dt_rank=SCAN_TRAIN[2], seed=2)]
    gg = torch.Generator(device="cuda").manual_seed(3)
    gy = torch.randn(leaves[0].shape, generator=gg, device="cuda")
    gh = torch.randn(leaves[0].shape[0], *leaves[2].shape, generator=gg,
                     device="cuda")
    scan_loss = lambda y, h: (y * gy).sum() + (h * gh).sum()
    dispatch.clear()
    got = torch.autograd.grad(scan_loss(*SelectiveScanFn.apply(*leaves)),
                              leaves)
    fn_launches = dispatch.stats()["by_kernel"]
    want = torch.autograd.grad(scan_loss(*selective_scan_ref(*leaves)),
                               leaves)
    grad_rel = {n: float(torch.linalg.vector_norm(g - w)
                         / torch.linalg.vector_norm(w).clamp_min(1e-30))
                for n, g, w in zip(("u", "dt", "A", "B", "C", "D"), got, want)}
    emit("scan_grad", case=dict(zip(("B", "S", "di", "N"), SCAN_TRAIN[1])),
         y_max_abs_err=scan_err, bwd_max_abs_err=scan_bwd_err,
         bwd_max_rel_err=scan_bwd_rel, grad_rel=grad_rel,
         launches=fn_launches, tol=SCAN_GRAD_TOL)
    check(fn_launches == {"ssm_scan": 1, "ssm_scan_bwd": 1},
          f"SelectiveScanFn runs one ssm_scan and one ssm_scan_bwd: "
          f"{fn_launches}")
    check(all(math.isfinite(v) and v <= SCAN_GRAD_TOL
              for v in grad_rel.values()),
          f"SelectiveScanFn gradients within {SCAN_GRAD_TOL}: {grad_rel}")
    del leaves, got, want, gy, gh
    torch.cuda.empty_cache()

    # 15. hymba-1.5b sync train at full width, 2 layers --------------------
    cfg_h = dataclasses.replace(get_config("hymba-1.5b"),
                                n_layers=HYMBA_LAYERS)
    hymba_launches = {}
    for tag, extra in SYNC_RUNS:
        args = train.parse_args(HYMBA_ARGS + extra)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        hres = train._train_sync(args, cfg_h, torch.device("cuda"))
        torch.cuda.synchronize()
        hwall = time.perf_counter() - t0
        hymba_launches[tag] = dispatch.stats()["by_kernel"]
        grads = args.nodes * (1 + hres["rounds"])
        emit("hymba_sync_train", run=tag, args=extra, n_layers=HYMBA_LAYERS,
             p=hres["p"], rounds=hres["rounds"], losses=hres["losses"],
             state_gb=hres["state_bytes"] / 1e9,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             memory_gb={k: {m: b / 1e9 for m, b in v.items()}
                        for k, v in hres["memory"].items()},
             resident_before_gb=resident / 1e9, wall_s=hwall,
             gradients=grads, launches=hymba_launches[tag],
             lemma3_rel=hres["mass_rel"], device=name, nvidia_smi=smi)
        check(all(math.isfinite(v) for v in hres["losses"]),
              f"hymba {tag}: finite losses")
        check(hymba_launches[tag] == {"ssm_scan": HYMBA_LAYERS * grads,
                                      "ssm_scan_bwd": HYMBA_LAYERS * grads,
                                      "commit_grid": hres["rounds"]},
              f"hymba {tag}: ssm_scan and ssm_scan_bwd once per layer per "
              f"gradient and commit_grid once per round: "
              f"{hymba_launches[tag]}")
        check(hres["mass_rel"] <= 1e-4, f"hymba {tag}: Lemma-3 <= 1e-4")
        torch.cuda.empty_cache()

    # 16. scan timing at the train shape and at two op widths --------------
    clock_hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scan_rows, bwd_rows = {}, {}
    for sname, shape, dt_rank in SCAN_TIMED:
        scan_rows[sname], bwd_rows[sname] = scan_timing(
            sname, shape, dt_rank, clock_hz, sms, name, smi)
    torch.cuda.empty_cache()

    # 17. the event oracle at full width ----------------------------------
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.simulator import run_sweep, sweep_plan
    topo4 = get_topology("binary_tree", 4)
    sched4 = get_scenario("uniform", 4).realize(topo4, 16, seed=0).schedule
    plan_4 = build_comm_plan(topo4)
    # full width and depth (phase 9 rebound ``cfg`` to a flash shape)
    prob = make_lm_problem(get_config("rfast-100m"), 4, batch_per_node=4,
                           seq_len=128, seed=0, device="cuda")
    H4, e_a4 = int(sched4.D) + 2, max(1, plan_4.n_edges_a)
    rows = state_rows(4, e_a4, H4)
    emit("event_oracle_plan", p=prob.p, events=sched4.K, H=H4, e_a=e_a4,
         state_rows=rows, state_gb=rows * prob.p * 4 / 1e9,
         kept_rows=4 * 4 + 2 * e_a4)
    oracle, kept = {}, None
    for mode, impl in (("event", "plain"), ("wavefront", "kernel")):
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        st, om = run_rfast(topo4, sched4, prob, prob.x0_flat, 3e-3, seed=0,
                           mode=mode, impl=impl, eval_fn=lambda s_, t: {},
                           device="cuda")
        torch.cuda.synchronize()
        oracle[mode] = dict(
            wall_s=time.perf_counter() - t0,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            commit_grid_launches=dispatch.launches("commit_grid"),
            waves=sum(m.get("waves", 0) for m in om),
            lemma3_rel=lemma3_rel(st))
        if kept is None:
            kept = {f: getattr(st, f).clone() for f in STATE_FIELDS}
        else:
            oracle_rel = field_rel(st, kept)
        del st
        torch.cuda.empty_cache()
    emit("event_oracle", p=prob.p, events=sched4.K, runs=oracle,
         rel_wavefront_vs_event=oracle_rel, tol=EVENT_TOL, device=name,
         nvidia_smi=smi)
    check(oracle["event"]["commit_grid_launches"] == 0,
          "the event engine launches no kernel")
    check(oracle["wavefront"]["commit_grid_launches"]
          == oracle["wavefront"]["waves"] > 0,
          "the wavefront engine launches commit_grid once per wave")
    check(max(oracle_rel.values()) <= EVENT_TOL,
          f"event and wavefront engines agree to {EVENT_TOL}: {oracle_rel}")
    check(all(r["lemma3_rel"] <= 1e-4 for r in oracle.values()),
          "Lemma-3 residual <= 1e-4 in both engines")
    del kept, prob
    torch.cuda.empty_cache()

    # 18. the fleet sweep: (a) the logistic fleet --------------------------
    from repro_torch.data.objectives import make_logistic_problem
    lprob = make_logistic_problem(LOGISTIC_N, heterogeneous=True,
                                  device="cuda")
    ltopo = get_topology("binary_tree", LOGISTIC_N)
    lscheds = [get_scenario(sc, LOGISTIC_N).realize(ltopo, FLEET_K,
                                                   seed=seed).schedule
               for sc, seed in FLEET_LANES]
    lseeds = [seed for _, seed in FLEET_LANES]
    lev = logistic_eval(lprob)
    lx0 = torch.zeros(lprob.p, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    fstates, fmetrics = run_sweep(
        [ltopo] * len(FLEET_LANES), lscheds, lprob, lx0, LOGISTIC_GAMMA,
        seeds=lseeds, eval_every=FLEET_EVAL, eval_fn=lev, device="cuda")
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    fleet_peak = torch.cuda.max_memory_allocated() / 1e9
    fleet_launches = dispatch.launches("commit_grid")
    fleet_waves = sum(m["waves"] for m in fmetrics[0])
    ffinal = [{f: getattr(st, f).clone() for f in STATE_FIELDS}
              for st in fstates]
    del fstates
    lane_rows, lane_waves, lane_wall = [], 0, 0.0
    for s_, ((sc, seed), sched) in enumerate(zip(FLEET_LANES, lscheds)):
        dispatch.clear()
        t0 = time.perf_counter()
        ref, _ = run_rfast(ltopo, sched, lprob, lx0, LOGISTIC_GAMMA,
                           seed=seed, eval_every=FLEET_EVAL, device="cuda")
        torch.cuda.synchronize()
        lane_wall += time.perf_counter() - t0
        lane_waves += dispatch.launches("commit_grid")
        ms_ = fmetrics[s_]
        lane_rows.append(dict(
            scenario=sc, seed=seed, loss_final=ms_[-1]["loss"],
            acc_final=ms_[-1]["acc"], vtime=ms_[-1]["t"],
            time_to_target=time_to(ms_, LOSS_TARGET),
            losses=[m["loss"] for m in ms_],
            rel_vs_run_rfast=max(field_rel(ffinal[s_], ref).values())))
        del ref
    fleet_err = max(r["rel_vs_run_rfast"] for r in lane_rows)
    emit("fleet_logistic", lanes=len(FLEET_LANES), n=LOGISTIC_N,
         events=FLEET_K, p=lprob.p, rows=lprob.n * lprob.X.shape[1],
         batch=lprob.batch,
         gamma=LOGISTIC_GAMMA, eval_every=FLEET_EVAL, fleet_waves=fleet_waves,
         commit_grid_launches=fleet_launches, lane_waves_sum=lane_waves,
         wall_s=fleet_wall, lanes_run_rfast_wall_s=lane_wall,
         max_memory_allocated_gb=fleet_peak, max_rel_err=fleet_err,
         tol=FLEET_TOL, loss_target=LOSS_TARGET, lane_results=lane_rows,
         device=name, nvidia_smi=smi)
    check(fleet_launches == fleet_waves > 0,
          "one commit_grid launch per fleet wave")
    check(fleet_waves < lane_waves,
          "the fleet runs fewer waves than its lanes alone")
    check(fleet_err <= FLEET_TOL,
          f"every lane equals run_rfast(seed) to {FLEET_TOL}: {fleet_err}")
    check(all(math.isfinite(r["loss_final"]) for r in lane_rows),
          "finite lane losses")
    del ffinal
    # the kernel at the logistic fleet's own shapes: its widest fleet
    # wave (Pf = 785) against the plain twin
    lsp = sweep_plan([build_comm_plan(ltopo)] * len(FLEET_LANES), lscheds,
                     FLEET_EVAL)
    lkw, lcase = fleet_wave_case(lsp, lseeds, LOGISTIC_N, lprob.p, seed=3)
    lwave = time_fleet_wave(lkw, lcase)
    emit("fleet_logistic_wave_timing", kernel="commit_grid", **lcase,
         **lwave, library_ms=None, device=name, nvidia_smi=smi)
    del lkw
    # the device's busy share over one traced short fleet (TRACE_K events
    # a lane), beside the same fleet's untraced wall
    tscheds = [get_scenario(sc, LOGISTIC_N).realize(ltopo, TRACE_K,
                                                   seed=seed).schedule
               for sc, seed in FLEET_LANES]
    tfleet = lambda: run_sweep([ltopo] * len(FLEET_LANES), tscheds, lprob,
                               lx0, LOGISTIC_GAMMA, seeds=lseeds,
                               device="cuda")
    t0 = time.perf_counter()
    tfleet()
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    busy = device_busy(tfleet)
    emit("fleet_logistic_trace", lanes=len(FLEET_LANES), events=TRACE_K,
         untraced_wall_s=untraced_s, **busy, device=name, nvidia_smi=smi)
    torch.cuda.empty_cache()

    # 18. (b) the fleet at a real row width: rfast-100m at 2 layers --------
    prob2 = make_lm_problem(cfg2, 4, batch_per_node=4, seq_len=128, seed=0,
                            device="cuda")
    scheds2 = [get_scenario("uniform", 4).realize(topo4, 16,
                                                  seed=s_).schedule
               for s_ in (0, 1)]
    S2 = len(scheds2)
    sp = sweep_plan([plan_4] * S2, scheds2, 16)
    rows2 = state_rows(4, sp.e_a, sp.H, S=S2)
    emit("fleet_lm_plan", p=prob2.p, lanes=S2, events=16, H=sp.H,
         e_a=sp.e_a, state_rows=rows2, state_gb=rows2 * prob2.p * 4 / 1e9)
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    states2, metrics2 = run_sweep([topo4] * S2, scheds2, prob2,
                                  prob2.x0_flat, 3e-3, seeds=[0, 1],
                                  eval_fn=lambda s_, t: {}, device="cuda")
    torch.cuda.synchronize()
    lm_wall = time.perf_counter() - t0
    lm_peak = torch.cuda.max_memory_allocated() / 1e9
    lm_launches = dispatch.launches("commit_grid")
    lm_waves = sum(m["waves"] for m in metrics2[0])
    lm_rel = []
    for s_ in range(S2):
        ref, _ = run_rfast(topo4, scheds2[s_], prob2, prob2.x0_flat, 3e-3,
                           seed=s_, device="cuda")
        lm_rel.append(field_rel(states2[s_], ref))
        del ref
        torch.cuda.empty_cache()
    del states2
    torch.cuda.empty_cache()
    emit("fleet_lm", p=prob2.p, lanes=S2, events=16, fleet_waves=lm_waves,
         commit_grid_launches=lm_launches, wall_s=lm_wall,
         max_memory_allocated_gb=lm_peak, rel_vs_run_rfast=lm_rel,
         tol=FLEET_TOL, device=name, nvidia_smi=smi)
    check(lm_launches == lm_waves > 0, "one commit_grid launch per fleet "
          "wave at rfast-100m width")
    check(max(max(r.values()) for r in lm_rel) <= FLEET_TOL,
          f"rfast-100m fleet lanes equal run_rfast(seed) to {FLEET_TOL}")
    # one fleet wave's commit_grid: the widest wave's tables over sources
    # with the fleet's row counts, at the model's width
    fkw, fcase = fleet_wave_case(sp, [0, 1], 4, prob2.p, seed=2)
    fwave = time_fleet_wave(fkw, fcase)
    emit("fleet_wave_timing", kernel="commit_grid", **fcase, **fwave,
         library_ms=None, device=name, nvidia_smi=smi)
    del fkw, prob2
    torch.cuda.empty_cache()

    # 19. the baselines on the card, beside the R-FAST lanes ---------------
    topos7 = {t: get_topology(t, LOGISTIC_N) for t in
              ("binary_tree", "directed_ring", "undirected_ring")}
    straggler = get_scenario("straggler", LOGISTIC_N)
    small = {dev: make_logistic_problem(LOGISTIC_N, m=700, d=16, batch=0,
                                        heterogeneous=True, device=dev)
             for dev in ("cuda", "cpu")}
    base_rows = {}
    for bname, tname in BASELINES:
        sync = bname in ("push_pull_sync", "sab", "ring_allreduce", "dpsgd")
        topo_b = topos7.get(tname)
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        _, bm = run_baseline(
            bname, topo_b, lprob, SYNC_ROUNDS if sync else ASYNC_K, "cuda",
            scenario=straggler, eval_every=10 if sync else 70, eval_fn=lev)
        torch.cuda.synchronize()
        row = dict(
            topology=tname, rounds=SYNC_ROUNDS if sync else None,
            events=None if sync else ASYNC_K, wall_s=time.perf_counter() - t0,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=dispatch.stats()["launches"],
            loss_final=bm[-1]["loss"], acc_final=bm[-1]["acc"],
            vtime=bm[-1]["t"], time_to_target=time_to(bm, LOSS_TARGET))
        # the card run against the CPU run at a small key-free size
        finals = [run_baseline(bname, topos7.get(tname), small[dev],
                               20 if sync else 140, dev,
                               scenario=straggler)[0].cpu()
                  for dev in ("cuda", "cpu")]
        row["rel_card_vs_cpu"] = float(
            (finals[0] - finals[1]).abs().max()
            / finals[1].abs().max().clamp_min(1e-30))
        base_rows[bname] = row
    rfast_lanes = [r for r in lane_rows if r["scenario"] == "straggler"]
    emit("baselines", scenario="straggler", n=LOGISTIC_N, p=lprob.p,
         gamma=LOGISTIC_GAMMA, loss_target=LOSS_TARGET, runners=base_rows,
         rfast_lanes=[{k: r[k] for k in ("seed", "loss_final", "acc_final",
                                         "vtime", "time_to_target")}
                      for r in rfast_lanes],
         rfast_fleet_wall_s=fleet_wall, tol=FLEET_TOL, device=name,
         nvidia_smi=smi)
    check(all(math.isfinite(r["loss_final"]) for r in base_rows.values()),
          "finite baseline losses")
    check(all(r["launches"] == 0 for r in base_rows.values()),
          "the baselines launch no kernel")
    check(all(r["rel_card_vs_cpu"] <= FLEET_TOL for r in base_rows.values()),
          f"every baseline's card run equals its CPU run to {FLEET_TOL}: "
          f"{ {k: r['rel_card_vs_cpu'] for k, r in base_rows.items()} }")
    del lprob, small
    torch.cuda.empty_cache()

    # 20. dynamic membership: (a) churn through train.main at full depth --
    from repro_torch.core.scenario import realize_epochs_batch
    from repro_torch.core.simulator import run_epochs, run_sweep_epochs
    et_churn = get_scenario("churn", 4).realize_epochs(
        get_topology("binary_tree", 4), CHURN_K, seed=0)
    (H20, *_, e_a20), _ = epoch_plans(et_churn, CHURN_EVERY)
    churn_waves = epoch_waves(et_churn, CHURN_EVERY)
    rows20 = state_rows(4, e_a20, H20)
    emit("epochs_churn_plan", events=CHURN_K, H=H20, e_a=e_a20,
         state_rows=rows20, state_gb=rows20 * p_run * 4 / 1e9,
         planner_waves=churn_waves,
         epochs=[(ep.k0, ep.K, ep.t0) for ep in et_churn.epochs])
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    cres = train.main(CHURN_ARGS)
    torch.cuda.synchronize()
    churn_wall = time.perf_counter() - t0
    churn_launches = dispatch.launches("commit_grid")
    emit("epochs_churn", p=cres["p"], events=cres["events"],
         epochs=cres["epoch_table"], losses=cres["losses"],
         waves=cres["waves"], commit_grid_launches=churn_launches,
         lemma3_rel=cres["mass_rel"], wall_s=churn_wall,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         state_gb=rows20 * cres["p"] * 4 / 1e9, device=name, nvidia_smi=smi)
    check(cres["mode"] == "async-dynamic" and cres["epochs"] == 3,
          "churn runs as three membership epochs")
    check(all(math.isfinite(v) for v in cres["losses"]), "finite losses")
    check(churn_launches == cres["waves"] == sum(churn_waves) > 0,
          f"one commit_grid launch per non-empty wave of every epoch: "
          f"{churn_launches} launches, {churn_waves} planned")
    check(cres["mass_rel"] <= 1e-4, "Lemma-3 residual <= 1e-4 after churn")
    torch.cuda.empty_cache()

    # 20. (b) root_failover at 2 layers: kernel against plain -------------
    prob20 = make_lm_problem(cfg2, 4, batch_per_node=4, seq_len=128, seed=0,
                             device="cuda")
    et_rf = get_scenario("root_failover", 4).realize_epochs(
        get_topology("robust_tree", 4), RF_K, seed=0)
    (H_rf, *_, e_a_rf), _ = epoch_plans(et_rf, RF_EVERY)
    rf_waves = epoch_waves(et_rf, RF_EVERY)
    rows_rf = state_rows(4, e_a_rf, H_rf)
    emit("epochs_root_failover_plan", p=prob20.p, events=RF_K, H=H_rf,
         e_a=e_a_rf, state_rows=rows_rf,
         state_gb=rows_rf * prob20.p * 4 / 1e9, planner_waves=rf_waves,
         epochs=[(ep.k0, ep.K, ep.t0, ep.root) for ep in et_rf.epochs])
    rf_runs, kept = {}, None
    for impl in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        st, rm = run_epochs(et_rf, prob20, prob20.x0_flat, 3e-3, seed=0,
                            eval_every=RF_EVERY, eval_fn=lambda s_, t: {},
                            impl=impl, device="cuda")
        torch.cuda.synchronize()
        rf_runs[impl] = dict(
            wall_s=time.perf_counter() - t0,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            commit_grid_launches=dispatch.launches("commit_grid"),
            waves=sum(m["waves"] for m in rm), lemma3_rel=lemma3_rel(st))
        if kept is None:
            kept = {f: getattr(st, f).clone() for f in STATE_FIELDS}
        else:
            rf_rel = field_rel(st, kept)
        del st
        torch.cuda.empty_cache()
    del kept
    emit("epochs_root_failover", p=prob20.p, events=RF_K, runs=rf_runs,
         rel_kernel_vs_plain=rf_rel, tol=FLEET_TOL, device=name,
         nvidia_smi=smi)
    check(rf_runs["kernel"]["commit_grid_launches"]
          == rf_runs["kernel"]["waves"] == sum(rf_waves) > 0,
          "root_failover: one commit_grid launch per non-empty wave")
    check(rf_runs["plain"]["commit_grid_launches"] == 0,
          "the plain backend launches no kernel")
    check(max(rf_rel.values()) <= FLEET_TOL,
          f"root_failover kernel and plain agree to {FLEET_TOL}: {rf_rel}")
    check(all(r["lemma3_rel"] <= 1e-4 for r in rf_runs.values()),
          "Lemma-3 residual <= 1e-4 after root_failover")
    # the widest epoch wave's commit_grid, held to its twin and timed
    ekw, ecase = epoch_wave_case(et_rf, RF_EVERY, 4, prob20.p, seed=4)
    ewave = time_fleet_wave(ekw, ecase)
    emit("epochs_wave_timing", kernel="commit_grid", **ecase, **ewave,
         library_ms=None, device=name, nvidia_smi=smi)
    del ekw, prob20
    torch.cuda.empty_cache()

    # 20. (c) the re-election claim on the paper's logistic objective ------
    lprob8 = make_logistic_problem(REELECT_N, m=2800, d=64, batch=16,
                                   heterogeneous=True, device="cuda")
    topo8 = get_topology("robust_tree", REELECT_N)
    sc8 = get_scenario("root_failover", REELECT_N)
    traces8 = realize_epochs_batch(topo8, REELECT_K, scenario=sc8,
                                   seeds=REELECT_SEEDS)
    ev8 = logistic_eval(lprob8)
    x8 = torch.zeros(lprob8.p, device="cuda")
    dispatch.clear()
    t0 = time.perf_counter()
    sts8, ms8 = run_sweep_epochs(traces8, lprob8, x8, REELECT_GAMMA,
                                 seeds=REELECT_SEEDS,
                                 eval_every=REELECT_EVERY, eval_fn=ev8,
                                 device="cuda")
    torch.cuda.synchronize()
    reelect_wall = time.perf_counter() - t0
    reelect_launches = dispatch.launches("commit_grid")
    reelect_waves = [sum(epoch_waves(tr, REELECT_EVERY)) for tr in traces8]
    reelect_rows = []
    for s_, tr in enumerate(traces8):
        solo, solo_m = run_epochs(tr, lprob8, x8, REELECT_GAMMA, seed=s_,
                                  eval_every=REELECT_EVERY, eval_fn=ev8,
                                  device="cuda")
        # the rings differ in depth (the fleet's H is the largest lane's)
        bitwise = all(torch.equal(getattr(sts8[s_], f), getattr(solo, f))
                      for f in STATE_FIELDS) and solo_m == ms8[s_]
        del solo
        _, frozen = run_rfast(topo8, sc8.realize(topo8, REELECT_K,
                                                 seed=s_).schedule,
                              lprob8, x8, REELECT_GAMMA, seed=s_,
                              eval_every=REELECT_EVERY, eval_fn=ev8,
                              device="cuda")
        post_e = [m["loss"] for m in ms8[s_] if m["t"] > 40.0]
        post_f = [m["loss"] for m in frozen if m["t"] > 40.0]
        reelect_rows.append(dict(
            seed=s_, epochs=[(ep.k0, ep.K, ep.root) for ep in tr.epochs],
            sweep_equals_run_epochs=bitwise,
            epochized_last_over_first_post_crash=ms8[s_][-1]["loss"]
            / post_e[0],
            frozen_plateau_max_over_min=max(post_f) / min(post_f),
            frozen_over_epochized_final=frozen[-1]["loss"]
            / ms8[s_][-1]["loss"],
            loss_final=ms8[s_][-1]["loss"], frozen_loss_final=frozen[-1][
                "loss"]))
    emit("epochs_logistic", n=REELECT_N, events=REELECT_K, p=lprob8.p,
         seeds=REELECT_SEEDS, gamma=REELECT_GAMMA, wall_s=reelect_wall,
         commit_grid_launches=reelect_launches, planner_waves=reelect_waves,
         lanes=reelect_rows, device=name, nvidia_smi=smi)
    check(reelect_launches == sum(m["waves"] for ms in ms8 for m in ms)
          == sum(reelect_waves), "run_sweep_epochs: one commit_grid launch "
          "per non-empty wave of every lane's epochs")
    check(all(r["sweep_equals_run_epochs"] for r in reelect_rows),
          "every run_sweep_epochs lane is bitwise its run_epochs")
    check(all(r["epochized_last_over_first_post_crash"] < 0.7
              and r["frozen_plateau_max_over_min"] < 1.05
              and r["frozen_over_epochized_final"] > 1.5
              for r in reelect_rows),
          "re-election: the epochized runs keep descending after the "
          "crash, the frozen plans stall")
    del sts8, lprob8
    torch.cuda.empty_cache()

    # 21. checkpoints: zip64, sync resume, async resume --------------------
    import os
    import shutil
    from repro_torch.checkpoint import (MANIFEST, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.core.protocol import ProtocolState
    from repro_torch.core.runtime import edge_arrays
    ck_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    ck_root.mkdir(parents=True)
    emit("ckpt_disk", path=str(ck_root.relative_to(ROOT)),
         free_gb=shutil.disk_usage(ck_root).free / 1e9)
    big = torch.randn(ZIP64_FLOATS, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(9))
    zdir = ck_root / "zip64"
    t0 = time.perf_counter()
    save_checkpoint(str(zdir), 1, {"big": big})
    zwrite = time.perf_counter() - t0
    t0 = time.perf_counter()
    zback = load_checkpoint(str(zdir), {"big": big})
    torch.cuda.synchronize()
    zread = time.perf_counter() - t0
    zbytes = (zdir / "step_0000000001.npz").stat().st_size
    zip_ok = zback["big"].is_cuda and torch.equal(zback["big"], big)
    del big, zback
    shutil.rmtree(zdir)
    emit("ckpt_zip64", member_bytes=ZIP64_FLOATS * 4, file_bytes=zbytes,
         write_gb_s=zbytes / zwrite / 1e9, read_gb_s=zbytes / zread / 1e9,
         bitwise=zip_ok, device=name, nvidia_smi=smi)
    check(zip_ok and ZIP64_FLOATS * 4 > 2 ** 32,
          "a member over 4 GiB (zip64) round-trips bitwise to the card")
    torch.cuda.empty_cache()

    # sync: 4 rounds saving every 2, against 2 rounds resumed to 4
    sa, sb = ck_root / "sync_a", ck_root / "sync_b"
    dispatch.clear()
    sruns = []
    for steps, d in ((4, sa), (2, sb), (4, sb)):
        args = train.parse_args(CKPT_SYNC_ARGS + ["--steps", str(steps),
                                                  "--ckpt", str(d)])
        sruns.append(train._train_sync(args, cfg2, torch.device("cuda")))
        torch.cuda.empty_cache()
    sync_resume_launches = dispatch.launches("commit_grid")
    step4 = "step_0000000004.npz"
    sync_equal = npz_equal(sa / step4, sb / step4)
    rspec2 = make_ravel_spec(init_params(cfg2, torch.Generator()
                                         .manual_seed(0)))
    e_pad2 = edge_arrays(get_topology("binary_tree", 2)).e_pad
    zrows = lambda r: torch.zeros(r, rspec2.p, device="cuda")
    sync_like = train.sync_tree(rspec2, ProtocolState(
        step=0, x=zrows(2), z=zrows(2), g_prev=zrows(2), rho=zrows(e_pad2),
        rho_buf=zrows(e_pad2), mail_v=None, m=None))
    shutil.rmtree(sb)
    sync_io = ckpt_io(sa, sync_like, ck_root / "sync_io")
    del sync_like
    shutil.rmtree(sa)
    shutil.rmtree(ck_root / "sync_io")
    emit("ckpt_sync", p=sruns[0]["p"], rounds=4, ckpt_every=2,
         losses=[r["losses"] for r in sruns], resumed_from=sruns[2]["start"],
         bitwise_step4=sync_equal, commit_grid_launches=sync_resume_launches,
         **sync_io, device=name, nvidia_smi=smi)
    check(sruns[2]["start"] == 2 and sync_equal
          and sruns[2]["losses"] == sruns[0]["losses"][2:],
          "a sync run resumed at round 2 is bitwise the uninterrupted one")
    check(sync_resume_launches == 4 + 2 + 2,
          "one commit_grid launch per sync round")
    torch.cuda.empty_cache()

    # async: run to the end; resume the step-16 file alone; nothing to redo
    aa, ab = ck_root / "async_a", ck_root / "async_b"
    step16, step32 = "step_0000000016.npz", "step_0000000032.npz"
    run_async = lambda d: train._train_async(
        train.parse_args(CKPT_ASYNC_ARGS + ["--ckpt", str(d)]), cfg2,
        torch.device("cuda"))
    dispatch.clear()
    ar1 = run_async(aa)
    torch.cuda.empty_cache()
    check(sorted(os.listdir(aa)) == [MANIFEST, step16, step32],
          "async checkpoints at k 16 and 32")
    ab.mkdir()
    os.link(aa / step16, ab / step16)
    (ab / MANIFEST).write_text(json.dumps(
        {"step": 16, "file": step16, "time": time.time(), "leaves": 9})
        + "\n")
    ar2 = run_async(ab)
    torch.cuda.empty_cache()
    async_equal = npz_equal(aa / step32, ab / step32)
    ar3 = run_async(ab)
    async_resume_launches = dispatch.launches("commit_grid")
    shutil.rmtree(ab)
    # the checkpoint I/O rates are the sync file's (ckpt_sync): timing the
    # async state's file once more re-times the same save / load path
    async_bytes = (aa / step32).stat().st_size
    shutil.rmtree(ck_root)
    torch.cuda.empty_cache()
    emit("ckpt_async", p=ar1["p"], events=32, chunk=16,
         state_gb=ar1["packed_bytes"] / 1e9,
         losses=[ar1["losses"], ar2["losses"], ar3["losses"]],
         resumed_from=[ar2["start"], ar3["start"]],
         bitwise_step32=async_equal,
         waves=[ar1["waves"], ar2["waves"], ar3["waves"]],
         commit_grid_launches=async_resume_launches, file_bytes=async_bytes,
         device=name, nvidia_smi=smi)
    check(ar2["start"] == 16 and async_equal,
          "an async run resumed at k 16 is bitwise the uninterrupted one")
    check(ar3["start"] == 32 and ar3["losses"] == ar3["losses"][:1],
          "a finished async run leaves nothing to redo")
    check(async_resume_launches == ar1["waves"] + ar2["waves"] > 0
          and ar3["waves"] == 0, "one commit_grid launch per wave run")

    # 22-24. serving -------------------------------------------------------
    publish_launches = phase_serve_rfast(name, smi)
    phase_serve_llama(name, smi)
    hymba_serve = phase_serve_hymba(name, smi)

    # 25-26. the model zoo -------------------------------------------------
    phase_zoo_serve(name, smi)
    zoo_launches = phase_zoo_train(name, smi)

    # 27-28. the enc-dec and frontend archs -------------------------------
    zoo_launches.update(phase_whisper(name, smi))
    zoo_launches.update(phase_pixtral(name, smi))

    # 29. the static analysis -----------------------------------------------
    analysis_launches = phase_analysis(name, smi, res,
                                       launches.get("commit_grid", 0))

    # 30. multi-device: ranks of this card ---------------------------------
    mesh_launches = phase_mesh(name, smi)

    # 31. the launch tooling's predictions against the card -------------
    mesh_launches.update(phase_launch(name, smi))

    # 32-36. the model axis tensor-parallel: the ranks spawned once -----
    tp_outs = tp_spawn()

    # 32. the model axis tensor-parallel ----------------------------------
    mesh_launches.update(phase_tensor_parallel(name, smi, tp_outs["32"]))

    # 33. the SSM archs' model axis tensor-parallel -----------------------
    tp_ssm = phase_tensor_parallel_ssm(name, smi, tp_outs["33"])
    mesh_launches.update({k: v for k, v in tp_ssm["launches"][
        "commit_grid"].items() if v})

    # 34. the MoE / MLA archs' model axis tensor-parallel -----------------
    mesh_launches.update(phase_tensor_parallel_moe(name, smi,
                                                   tp_outs["34"]))

    # 35. the enc-dec and frontend archs' model axis tensor-parallel ------
    mesh_launches.update(phase_tensor_parallel_front(name, smi,
                                                     tp_outs["35"]))

    # 36. prefill and decode with the model axis tensor-parallel ----------
    tp_serve = phase_tensor_parallel_serve(name, smi, tp_outs["36"])

    grid_paths = {
        "async_train": launches.get("commit_grid", 0),
        **{f"sync_train_{t}": v.get("commit_grid", 0)
           for t, v in sync_launches.items()},
        **{f"hymba_sync_train_{t}": v.get("commit_grid", 0)
           for t, v in hymba_launches.items()},
        "event_oracle": oracle["event"]["commit_grid_launches"],
        "event_oracle_wavefront": oracle["wavefront"]["commit_grid_launches"],
        "fleet_logistic": fleet_launches, "fleet_lm": lm_launches,
        "epochs_churn": churn_launches,
        "epochs_root_failover": rf_runs["kernel"]["commit_grid_launches"],
        "epochs_logistic": reelect_launches,
        "sync_resume": sync_resume_launches,
        "async_resume": async_resume_launches,
        "serve_publish": publish_launches.get("commit_grid", 0),
        **zoo_launches, **analysis_launches, **mesh_launches}
    kernels = [{
        "name": "commit_grid", "route": "cuda",
        "source": str(grid.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/rfast_update/grid.py:192",
        "launches": sum(grid_paths.values()),
        "launches_by_path": grid_paths,
        "max_abs_err": max(main_err, fwave["max_abs_err"],
                           lwave["max_abs_err"], ewave["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "round_shape": {"ms": round_ms, "plain_ms": round_plain_ms,
                        "bound_ms": round_bound},
        "fleet_wave_shape": {k: v for k, v in {**fcase, **fwave}.items()
                             if k != "rows"},
        "fleet_logistic_wave_shape": {k: v for k, v in {**lcase,
                                                       **lwave}.items()
                                      if k != "rows"},
        "epoch_wave_shape": {k: v for k, v in {**ecase, **ewave}.items()
                             if k != "rows"}}]
    for kname, src, rep in (
            ("flash_fwd_3xtf32", fa_fwd.KERNEL_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:85"),
            ("flash_bwd_3xtf32", fa_bwd.KERNEL_SOURCE,
             "src/repro/kernels/flash_attention/backward.py:135, "
             "src/repro/kernels/flash_attention/backward.py:156"),
            ("flash_fwd_tc", fa_fwd.TC_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:85"),
            ("flash_bwd_tc", fa_bwd.TC_SOURCE,
             "src/repro/kernels/flash_attention/backward.py:135, "
             "src/repro/kernels/flash_attention/backward.py:156")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": str(src.relative_to(ROOT)),
                        "replaces": rep,
                        "launches": flash_launches.get(kname, 0),
                        "max_abs_err": flash_err[kname],
                        **flash_rows[kname]})
    for kname, rep, nl in (
            ("rfast_update_node",
             "src/repro/kernels/rfast_update/kernel.py:143",
             node_op_launches.get("rfast_update_node", 0)),
            ("rfast_commit_node",
             "src/repro/kernels/rfast_update/kernel.py:113",
             route_launches["oracle"].get("rfast_commit_node", 0))):
        row = node_rows[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": str(node_k.KERNEL_SOURCE.relative_to(ROOT)),
                        "replaces": rep, "launches": nl,
                        "max_abs_err": node_err[kname],
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")},
                        "library_ms": None})
    train_row = scan_rows[SCAN_TRAIN[0]]
    scan_paths = {
        **{f"hymba_sync_train_{t}": v.get("ssm_scan", 0)
           for t, v in hymba_launches.items()},
        "hymba_serve_prefill_cache": hymba_serve["prefill_cache"],
        "hymba_serve_forward": hymba_serve["forward"],
        **tp_ssm["launches"]["ssm_scan"], **tp_serve["launches"]}
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": str(scan_k.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:62",
        "launches": sum(scan_paths.values()),
        "launches_by_path": scan_paths,
        "max_abs_err": max(scan_err, hymba_serve["max_abs_err"],
                           tp_ssm["max_abs_err"]["ssm_scan"],
                           tp_serve["max_abs_err"]),
        "max_abs_err_by_shape": {"train": scan_err,
                                 **hymba_serve["err_by_shape"],
                                 "tp_rank_shapes":
                                 tp_ssm["max_abs_err"]["ssm_scan"],
                                 **tp_serve["err_by_shape"]},
        **train_row, "library_ms": None,
        "op_widths": {k: v for k, v in scan_rows.items()
                      if k != SCAN_TRAIN[0]},
        "rank_shapes": tp_ssm["rows"]["ssm_scan"]})
    bwd_paths = {
        **{f"hymba_sync_train_{t}": v.get("ssm_scan_bwd", 0)
           for t, v in hymba_launches.items()},
        **tp_ssm["launches"]["ssm_scan_bwd"]}
    kernels.append({
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": str(scan_b.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/models/ssm.py:42 (the gradient of "
                    "selective_scan_ref: lax.scan autodiff, no Pallas "
                    "kernel)",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": max(scan_bwd_err,
                           tp_ssm["max_abs_err"]["ssm_scan_bwd"]),
        **bwd_rows[SCAN_TRAIN[0]], "library_ms": None,
        "op_widths": {k: v for k, v in bwd_rows.items()
                      if k != SCAN_TRAIN[0]},
        "rank_shapes": tp_ssm["rows"]["ssm_scan_bwd"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
