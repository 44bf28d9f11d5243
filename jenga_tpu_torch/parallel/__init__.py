"""Sequence parallelism over ``torch.distributed``: Ulysses, ring and ring x
Ulysses attention, and FSDP-style weight sharding.

Port of ``jenga_tpu/parallel/``. The JAX package writes each collective
inside a ``shard_map`` island over a ``jax.sharding.Mesh`` and lets XLA
place the arrays around it; here every rank runs its own program over a
``DeviceMesh`` (``mesh.make_sp_mesh``: dims ``("sp",)``, or ``("ring",
"sp")`` with the Ulysses axis innermost) and the collectives are explicit.
What the two share is the output: the same velocity, whatever the layout
inside.

Layout. Each rank holds one contiguous slice of the **curve-ordered**
token stream over the model's token axes (``mesh.token_mesh``): slice
``ring_index * ulysses + ulysses_index`` of ``ring x ulysses`` slices
(ring-major), of sizes ``ceil(L / n)``, the last ones shorter, even empty
(``mesh.shard_sizes``). The ranks of any other axis hold copies of the
same slices. Uneven slices are the rule, not an exception: HunyuanVideo
Turbo's stage 0 has 9 x 33 x 60 = 17,820 image tokens, a multiple of
neither 8 nor 128.
- HunyuanVideo: the slices are of the image stream, over ``ring`` x
  ``sp``; the text stream stays whole and identical on every rank (the
  reference's joint "rear" strategy). Wan: of the 128-padded sequence,
  over ``sp`` alone (copied over ``ring``, so it keeps carving there, as
  the JAX package does). Both copy over ``dp``
  (``mesh.make_multihost_sp_mesh``).
- The models shard in ``embed`` (after the curve order) and gather at the
  start of ``head`` (before the inverse order), so the velocity, the
  scheduler step and every random draw are replicated and identical on
  every rank: each rank receives the same gathered bytes.
- Ulysses (``ulysses.py``) trades the token slice for a head slice with
  ``all_to_all_single``: inside, each rank holds the full sequence for
  ``H / ulysses`` heads, so the planner and the block-sparse kernel run
  per rank on its local heads, unchanged (one K1 launch a layer, as on
  one device).
- Ring (``ring.py``) rotates K|V around the ring with
  ``batch_isend_irecv`` and merges each chunk's partial attention, one
  launch of the dense kernel D with its base-2 row statistics, through
  natural-log log-sum-exps.
- FSDP (``mesh.shard_params_fsdp``): JAX's layout, each large tensor
  split along one dimension over the ``sp`` axis; a block all-gathers its
  shards before its forward and frees them after.
``replicate`` has no counterpart: every rank builds or loads the same
weights (one seed, one checkpoint) and keeps its own copy of the inputs.

Every rank must make the same calls in the same order: a collective
with no partner waits for ever, so the tests run each rank as a
subprocess with its own time limit.
"""
