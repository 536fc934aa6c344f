"""PyTorch / CUDA port of ``neuma_tpu`` for NVIDIA Hopper (H100).

The JAX package ``neuma_tpu`` stays the reference; this package mirrors
its subpackages and module names (``core``, ``ops``, ``nn``,
``materials``, ``sim``, ``render``, ``train``) so each counterpart is
found by path. Plain tensor code is PyTorch; every Pallas TPU kernel on
the ported path is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` on first use (``kernels.py``) and bound through ``ctypes``.

Ported so far: the grounding rollout (``train/grounding.py::make_rollout_loss``:
elasticity MLP -> MPM step (slab branch through the P2G and G2P kernels,
dense branch for small grids) -> plasticity MLP -> binding -> Particle-GS
rasterizer (tile-composite kernels)), its BPTT backward, both trainers,
every CLI of ``apps/`` (training, rendering, inference, registration,
evaluation, the viewer) with the modules they reach, the alternative
backends of ``p2g`` and of the rasterizer, the end-to-end example
(``examples/smoke_e2e.py``), and scale-out over ``torch.distributed``
(``parallel/``): the rollout over a mesh with the halo-exchange grid
(``grid_mode="halo"``) or with particle shards on a replicated grid
(``grid_mode="replicated"``, the differentiable sharded step), each
view's image tiles split over a mesh axis (``RasterConfig.tile_sharding``:
K4 and K5 over each rank's range of tiles), the multi-rank dry run,
the speed-of-light model ``utils/roofline.py`` (the H100 SXM's peaks),
each subpackage's exports, name for name as in the JAX package, the
JAX package's jnp raster backend (``RasterConfig(backend="jnp")``: each
tile's depth list cut at ``max_per_tile``, composited by the same
kernels), every field of its ``RasterConfig`` and ``ops/bitonic.py``.
The port does everything the JAX package does; what it leaves out is
that package's private JAX plumbing and its Pallas module, whose
counterparts are ``csrc/`` and ``render/raster_kernel.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without an explicit CPU request they raise.
"""
