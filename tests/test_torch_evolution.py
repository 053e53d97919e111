"""The port's evolutionary transform search against the JAX package's (CPU).

- ``random_individual``, ``mutate`` and ``crossover`` on ``random.Random``
  give JAX's genomes for seeds 0-19 (equal);
- ``evolutionary_search`` with one deterministic fitness monkeypatched into
  both modules' ``fitness_fn``: the same genomes in every call, in order,
  and the same best (equal);
- ``fitness_fn`` on a linear model at 8x32x32x3 for the 16 noise-free gene
  combos and for 2-gene genomes: within 1e-3 relative of JAX's (JAX's
  universal route on the CPU, its fused blur in Pallas interpret mode);
- the route: a genome of pool genes runs one one-op chain a gene, in slot
  order; any other genome runs its whole chain once.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.adapt import evolution as je
from imagetransformations_tpu_torch.adapt import evolution as pe
from imagetransformations_tpu_torch.pipeline.chain import build_chain_fn

FITNESS_RTOL = 1e-3
NOISE_FREE = [c for c in je._GENE_COMBOS if "noise" not in c[0]]
PAIRS = [(("blur", 1.0), ("sharpness", 1.5)), (("enhance_contrast", 1.2), ("blur", 0.5)),
         (("histogram_equalization", None), ("enhance_color", 0.8)),
         (("brightness", 0.1), ("blur", 1.5))]


def test_pool_and_tables_are_jax_s():
    assert pe.GENE_POOL == je.GENE_POOL
    assert list(pe.GENE_POOL) == list(je.GENE_POOL)
    assert pe._PARAM_KEY == je._PARAM_KEY
    assert pe._GENE_COMBOS == je._GENE_COMBOS and pe._COMBO_INDEX == je._COMBO_INDEX
    assert len(NOISE_FREE) == 16
    ind = [("blur", 1.0), ("histogram_equalization", None)]
    got = [(s.name, s.params) for s in pe.Individual(ind).to_chain()]
    assert got == [(s.name, s.params) for s in je.Individual(ind).to_chain()]


@pytest.mark.parametrize("seed", range(20))
def test_genetic_operators_replay_jax(seed):
    rj, rp = random.Random(seed), random.Random(seed)
    for length in (1, 2, 3):
        a_j, a_p = je.random_individual(rj, length), pe.random_individual(rp, length)
        b_j, b_p = je.random_individual(rj), pe.random_individual(rp)
        assert a_p.genome == a_j.genome and b_p.genome == b_j.genome
        c_j, c_p = je.crossover(a_j, b_j, rj), pe.crossover(a_p, b_p, rp)
        assert c_p.genome == c_j.genome
        for rate in (0.3, 0.9):
            assert pe.mutate(c_p, rp, rate).genome == je.mutate(c_j, rj, rate).genome
    assert rp.random() == rj.random()  # the same number of draws


def test_search_replays_jax_genomes(monkeypatch):
    """One fitness of the genome alone in both modules: every call sees the
    same genome in the same order, and the best is the same."""
    def fake(calls):
        def fitness(model_fn, to_model_space, images, ind, key, **kwargs):
            calls.append(list(ind.genome))
            return float(sum((i + 1) * (je._COMBO_INDEX[g] % 7 + 1)
                             for i, g in enumerate(ind.genome)) % 11) / 11.0
        return fitness

    cj, cp = [], []
    monkeypatch.setattr(je, "fitness_fn", fake(cj))
    monkeypatch.setattr(pe, "fitness_fn", fake(cp))
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    for kwargs in ({}, {"population_size": 6, "generations": 3, "elite": 2, "seed": 5}):
        cj.clear()
        cp.clear()
        bj = je.evolutionary_search(None, None, jnp.asarray(imgs), **kwargs)
        bp = pe.evolutionary_search(None, None, imgs, device="cpu", **kwargs)
        assert cp == cj
        assert len(cp) == kwargs.get("population_size", 16) * (kwargs.get("generations", 4) + 1)
        assert bp.genome == bj.genome and bp.fitness == bj.fitness


@pytest.fixture(scope="module")
def linear():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3072, 10)) * 0.1).astype(np.float32)
    imgs = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    return dict(
        imgs=imgs,
        jfn=lambda x: x.reshape(x.shape[0], -1) @ wj,
        jto=lambda u: u.astype(jnp.float32) / 255.0,
        pfn=lambda x: x.reshape(x.shape[0], -1) @ wt,
        pto=lambda u: u.to(torch.float32) / 255.0,
    )


def _both(linear, genome):
    want = je.fitness_fn(linear["jfn"], linear["jto"], jnp.asarray(linear["imgs"]),
                         je.Individual(list(genome)), jax.random.key(0))
    got = pe.fitness_fn(linear["pfn"], linear["pto"], linear["imgs"],
                        pe.Individual(list(genome)), device="cpu")
    return got, want


@pytest.mark.parametrize("gene", NOISE_FREE, ids=lambda g: f"{g[0]}-{g[1]}")
def test_fitness_matches_jax_one_gene(linear, gene):
    got, want = _both(linear, [gene])
    assert abs(got - want) <= FITNESS_RTOL * abs(want), (gene, got, want)


@pytest.mark.parametrize("genome", PAIRS, ids=lambda g: "+".join(f"{o}-{v}" for o, v in g))
def test_fitness_matches_jax_two_genes(linear, genome):
    got, want = _both(linear, genome)
    assert abs(got - want) <= FITNESS_RTOL * abs(want), (genome, got, want)


def test_fitness_routes(linear, monkeypatch):
    """Pool genes: one one-op chain a gene, in slot order, with the caller's
    generator; a gene outside the pool: the genome's whole chain."""
    built = []

    def recording(chain, **kwargs):
        built.append([(s.name, dict(s.params)) for s in chain])
        return build_chain_fn(chain, **kwargs)

    monkeypatch.setattr(pe, "build_chain_fn", recording)
    imgs = linear["imgs"]
    g = torch.Generator().manual_seed(1)
    pool = pe.Individual([("gaussian_noise", 0.04), ("blur", 1.0)])
    got = pe.transform_genome(imgs, pool, g, device="cpu")
    assert built == [[("gaussian_noise", {"std": 0.04})], [("blur", {"radius": 1.0})]]
    g2 = torch.Generator().manual_seed(1)
    x = build_chain_fn(pool.to_chain()[:1], device="cpu")(imgs, g2)
    assert torch.equal(got, build_chain_fn(pool.to_chain()[1:], device="cpu")(x, g2))
    built.clear()
    other = pe.Individual([("blur", 0.7), ("sharpness", 1.5)])  # radius 0.7: not a gene
    got = pe.transform_genome(imgs, other, device="cpu")
    assert built == [[("blur", {"radius": 0.7}), ("sharpness", {"factor": 1.5})]]
    assert torch.equal(got, build_chain_fn(other.to_chain(), device="cpu")(imgs))
    f = pe.fitness_fn(linear["pfn"], linear["pto"], imgs, other, device="cpu")
    assert 0.5 <= f <= 1.0


def test_search_runs_and_defaults_to_the_card(linear, monkeypatch):
    best = pe.evolutionary_search(linear["pfn"], linear["pto"], linear["imgs"],
                                  population_size=6, generations=2, elite=2, device="cpu")
    assert 0.5 <= best.fitness <= 1.0 and len(best.genome) >= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pe.evolutionary_search(linear["pfn"], linear["pto"], linear["imgs"])
