"""The parts of the reference that are frozen copies of the port's plain
code (the curves, the block neighbours, the UniPC solver), held to their
definitions restated here at small sizes, so that a fault the copy shares
with the port cannot pass unseen:

  * a curve visits every token once, each step to one of the 26
    neighbours of the last;
  * two blocks are neighbours when a voxel of one touches a voxel of the
    other in the 26-neighbourhood (a direct scan over the voxels);
  * UniPC with B(h) = e^h - 1 (bh2), data prediction, order 2 with the
    first step and the last at order 1: the predictor UniP and the
    corrector UniC in their closed form, over a whole trajectory.
"""

import math

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts the checkout on sys.path)
from benchmark.reference import unipc
from benchmark.reference.curves import blocks

GRIDS = [(3, 5, 7), (4, 6, 10), (2, 9, 4), (5, 4, 4)]


def _coords(grid):
    t, h, w = grid
    z, y, x = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                          indexing="ij")
    return np.stack([z.ravel(), y.ravel(), x.ravel()], axis=1)


@pytest.mark.parametrize("kind", ["gilbert", "sliced"])
@pytest.mark.parametrize("grid", GRIDS)
def test_curve_is_a_path_over_every_token(kind, grid):
    plan = blocks.build_curve_plan(grid, kind, 8)
    n = int(np.prod(grid))
    order = plan.curve_order.astype(np.int64)
    assert sorted(order.tolist()) == list(range(n))
    assert np.array_equal(plan.linear_to_curve[order], np.arange(n))
    steps = np.abs(np.diff(_coords(grid)[order], axis=0))
    assert steps.max() <= 1 and (steps.sum(axis=1) >= 1).all()


@pytest.mark.parametrize("kind", ["gilbert", "sliced"])
@pytest.mark.parametrize("grid,block", [(g, b) for g in GRIDS
                                        for b in (8, 16)])
def test_block_neighbours_are_the_26_neighbourhood(kind, grid, block):
    plan = blocks.build_curve_plan(grid, kind, block)
    t, h, w = grid
    color = {tuple(c): int(plan.linear_to_curve[i]) // block
             for i, c in enumerate(_coords(grid))}
    nb = -(-t * h * w // block)
    want = np.eye(nb, dtype=bool)
    for (z, y, x), a in color.items():
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    b = color.get((z + dz, y + dy, x + dx))
                    if b is not None:
                        want[a, b] = True
    assert np.array_equal(plan.block_neighbors, want)


def _phi(k, z):
    """phi_k(z) = (e^z - sum_{j<k} z^j / j!) / z^k."""
    return (math.exp(z) - sum(z ** j / math.factorial(j)
                              for j in range(k))) / z ** k


class _UniPCbh2:
    """The solver from its published formula (Zhao et al., 2023, UniPC,
    B(h) = e^h - 1, data prediction), for order 2. Flow matching:
    alpha = 1 - sigma, lambda = log(alpha / sigma), x0 = x - sigma v."""

    def __init__(self, steps, shift):
        s = np.linspace(1 - 1 / 1000, 0, steps + 1)[:-1]
        self.sigmas = np.append(shift * s / (1 + (shift - 1) * s), 0.0)
        self.steps = steps
        self.m = []             # x0 predictions, newest last
        self.last = None        # the sample the last predictor started at
        self.last_order = 0

    def lam(self, i):
        s = self.sigmas[i]
        return math.inf if s == 0 else math.log((1 - s) / s)

    def step(self, i, v, x):
        sig = self.sigmas
        m_i = x - sig[i] * v
        if i > 0:
            # UniC: correct the last predictor step with m_i
            h = self.lam(i) - self.lam(i - 1)
            a, z = 1 - sig[i], -h
            base = (sig[i] / sig[i - 1] * self.last
                    - a * math.expm1(z) * self.m[-1])
            bh = math.expm1(z)
            if self.last_order == 1:
                rho_t, corr = 0.5, 0.0
            else:
                r = (self.lam(i - 2) - self.lam(i - 1)) / h
                b1 = 1 * z * _phi(2, z) / bh
                b2 = 2 * z * _phi(3, z) / bh
                rho_r = (b1 - b2) / (1 - r)
                rho_t = b1 - rho_r
                corr = rho_r * (self.m[-2] - self.m[-1]) / r
            x = base - a * bh * (corr + rho_t * (m_i - self.m[-1]))
        self.m = (self.m + [m_i])[-2:]
        order = min(2, self.steps - i, i + 1)
        # UniP from sigma_i to sigma_{i+1}
        h = self.lam(i + 1) - self.lam(i)
        a, z = 1 - sig[i + 1], -h
        out = sig[i + 1] / sig[i] * x - a * math.expm1(z) * m_i
        if order == 2:
            r = (self.lam(i - 1) - self.lam(i)) / h
            out = out - a * math.expm1(z) * 0.5 * (self.m[-2] - m_i) / r
        self.last, self.last_order = x, order
        return out


@pytest.mark.parametrize("steps,shift", [(10, 8.0), (7, 1.0), (50, 8.0)])
def test_unipc_copy_follows_the_formula(steps, shift):
    gen = torch.Generator().manual_seed(steps)
    a = torch.randn(6, 6, generator=gen, dtype=torch.float64) * 0.3
    c = torch.randn(steps, 6, 5, generator=gen, dtype=torch.float64)
    x0 = torch.randn(6, 5, generator=gen, dtype=torch.float64)

    def velocity(i, x):
        return a @ x + c[i]

    sched = unipc.unipc_schedule(steps, shift=shift)
    ref = _UniPCbh2(steps, shift)
    np.testing.assert_allclose(sched.sigmas, ref.sigmas, rtol=1e-15)
    state, x, y = unipc.unipc_init(sched), x0.float(), x0
    for i in range(steps):
        state, x = unipc.unipc_step(sched, state, velocity(i, x.double())
                                    .float(), x)
        y = ref.step(i, velocity(i, y), y)
        np.testing.assert_allclose(x.double().numpy(), y.numpy(),
                                   rtol=0, atol=2e-5 * float(y.abs().max()))
