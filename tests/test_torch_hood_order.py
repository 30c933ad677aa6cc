"""The order in which both segmentation routes' CUDA kernels sum a hood's
energies (``csrc/plainsum.cuh``): a warp walks the hood in chunks of 32
consecutive elements and, after each chunk, adds the valid lanes'
products to one float32 accumulator one lane at a time.  A numpy float32
model of that loop is held here, bit for bit, to

* ``repro_torch.kernels.ref.keyed_sum`` (``index_add_``, the port's plain
  path on the CPU) and the JAX package's ``jax.ops.segment_sum`` on the
  CPU, at hoods of 1, 31, 32, 33, 100 and 300 elements with padding lanes;
* the sharded route's plain step on the element blocks of
  ``partition_hoods(hoods, 2)`` and ``(hoods, 4)``: each rank's partial
  over the part of every hood in its block (``map_step.hood_runs``), and
  the partials added over the ranks.

``chip_smoke.py`` holds the kernels to the plain steps on the CPU bit for
bit at every launch of whole 512x512 solves; the model here pins the
order they follow.  Everything is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import synthetic
from repro_torch.core.pmrf import distributed as D
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf import pipeline
from repro_torch.kernels import map_step, ref
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

WARP = 32
HOOD_SIZES = (1, 31, 32, 33, 100, 300)


def chunk_sum(products: np.ndarray, take: np.ndarray, begin: int, end: int) -> np.float32:
    """The kernel's loop over elements [begin, end): chunks of 32, each
    chunk's taken products added to the accumulator in lane order."""
    acc = np.float32(0.0)
    for base in range(begin, end, WARP):
        for lane in range(min(WARP, end - base)):
            if take[base + lane]:
                acc = np.float32(acc + products[base + lane])
    return acc


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _hoods_problem(seed: int):
    """Hoods of ``HOOD_SIZES`` elements, stored hood after hood; products
    of mixed sign over five decades and about 15 % padding lanes."""
    rng = np.random.default_rng(seed)
    sizes = np.array(HOOD_SIZES)
    hood_id = np.repeat(np.arange(sizes.size), sizes).astype(np.int32)
    n = hood_id.size
    products = (rng.normal(0.0, 1.0, n) * 10.0 ** rng.uniform(-2, 3, n)).astype(np.float32)
    valid = rng.random(n) >= 0.15
    return sizes, hood_id, products, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_loop_is_element_order(seed):
    sizes, hood_id, products, valid = _hoods_problem(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    model = np.array([chunk_sum(products, valid, offsets[h], offsets[h + 1])
                      for h in range(sizes.size)], np.float32)
    keys = np.where(valid, hood_id, sizes.size)  # padding to a spare segment, as the plain path does
    port = ref.keyed_sum(torch.from_numpy(products), torch.from_numpy(keys), sizes.size).numpy()
    jax_sum = np.asarray(jax.ops.segment_sum(jnp.asarray(products), jnp.asarray(keys), sizes.size + 1))
    np.testing.assert_array_equal(_bits(model), _bits(port))
    np.testing.assert_array_equal(_bits(model), _bits(jax_sum[: sizes.size]))
    # A tree over the 32 lanes (the K = 2..8 tick's order before) is another sum.
    tree = []
    for h in range(sizes.size):
        part = np.where(valid, products, 0)[offsets[h]:offsets[h + 1]]
        lanes = np.zeros(WARP, np.float32)
        for i, v in enumerate(part):
            lanes[i % WARP] = np.float32(lanes[i % WARP] + v)
        while lanes.size > 1:
            lanes = (lanes[: lanes.size // 2] + lanes[lanes.size // 2:]).astype(np.float32)
        tree.append(lanes[0])
    assert not np.array_equal(_bits(tree), _bits(model))


_plan = {}


def _k3_problem():
    if not _plan:
        vol = synthetic.make_kary_volume(seed=0, n_slices=1, shape=(48, 48), n_phases=3, device="cpu")
        _plan["p"] = pipeline.initialize(vol.images[0], overseg_grid=(7, 7), n_labels=3, device="cpu")
    return _plan["p"]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_rank_partials_at_block_edges(n_shards):
    """Each rank sums the part of every hood in its block in element order;
    hoods that straddle a block edge get one partial from each rank, and
    the partials added over the ranks are the plain route's."""
    prob = _k3_problem()
    parts = D.partition_hoods(prob.hoods, n_shards)
    labels, mu, sigma = pipeline.initial_params(prob, 0, "quantile")
    sctx = E.make_static_context(parts, prob.model)
    args, kw = E.map_step_operands(parts, prob.model, sctx, labels, mu, sigma)
    min_e, _, _, _ = ref.fused_map_step(*args, **kw)
    valid = args[5].numpy()
    products = (min_e * args[5]).numpy()
    nh = kw["n_hoods"]
    straddling = 0
    model_total = np.zeros(nh, np.float32)
    plain_total = np.zeros(nh, np.float32)
    for rank in range(n_shards):
        ranges, hood_lo, block = map_step.hood_runs(parts, rank, n_shards)
        straddling += int(np.sum((ranges[:, 2] > ranges[:, 0]) | (ranges[:, 3] < ranges[:, 1])))
        model = np.zeros(nh, np.float32)
        for j, (_, _, begin, end) in enumerate(ranges):
            model[hood_lo + j] = chunk_sum(products, valid > 0, begin, end)
        b = slice(rank * block, (rank + 1) * block)
        block_args = [a[:, b] if a.dim() == 2 else a[b] for a in args[:8]] + list(args[8:])
        _, _, plain, _ = ref.fused_map_step(*block_args, **kw)
        np.testing.assert_array_equal(_bits(model), _bits(plain.numpy()))
        model_total = (model_total + model).astype(np.float32)
        plain_total = (plain_total + plain.numpy()).astype(np.float32)
    assert straddling > 0
    np.testing.assert_array_equal(_bits(model_total), _bits(plain_total))
