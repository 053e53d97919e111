"""Evolutionary transform search: population on the host, fitness on the
device (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/evolution.py``; parity with
pipenline/cifar_image_transformations.py:
- Individual genome = list of (op_name, params) (:132-147)
- mutate / crossover (:149-175)
- fitness = 1/(1+uncertainty); uncertainty = 1.0 if MSP < threshold else
  1 - MSP (:177-201)
- evolutionary_search (:232-289): population 15-20, 3-5 generations,
  elitism + crossover + random immigrants.

``GENE_POOL``, ``_PARAM_KEY``, ``random_individual``, ``mutate``,
``crossover`` and the search's host loop are the JAX package's, on the same
``random.Random``, so a seed gives the same genomes in both packages.

The fitness follows JAX's route: a genome drawn from ``GENE_POOL`` is
applied gene by gene, each gene its own one-op chain
(``build_chain_fn([spec], jit=False)``), u8 between genes; any other genome
runs as one chain. The two are different functions (a non-strict chain
keeps f32 between fused ops). A ``blur`` gene on an NHWC uint8 RGB batch
runs the fused kernel at angle 0 (``fused_blur_rotate_image``: kernel #3,
``csrc/rgb_blur_rotate.cu``, in stream mode). JAX's executable caches
(``_UNIVERSAL_CACHE``'s ``lax.switch`` table, ``_FITNESS_CACHE``) are
compile workarounds with nothing to do in eager PyTorch; ``_GENE_COMBOS``
and ``_COMBO_INDEX`` keep their names. The noise genes draw from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn

#: gene pool mirrors TransformationPool (cifar_image_transformations.py:37-129)
GENE_POOL: dict[str, Sequence] = {
    "gaussian_noise": [0.02, 0.04, 0.08],
    "impulse_noise": [0.03, 0.09, 0.17],
    "blur": [0.5, 1.0, 1.5],
    "sharpness": [1.2, 1.5, 2.0],
    "enhance_contrast": [0.8, 1.0, 1.2],
    "brightness": [-0.1, 0.0, 0.1],
    "enhance_color": [0.8, 1.0, 1.2],
    "histogram_equalization": [None],
}

_PARAM_KEY = {
    "gaussian_noise": "std",
    "impulse_noise": "amount",
    "blur": "radius",
    "sharpness": "factor",
    "enhance_contrast": "factor",
    "brightness": "factor",
    "enhance_color": "factor",
}


def _spec(op: str, val) -> OpSpec:
    pk = _PARAM_KEY.get(op)
    return OpSpec(op, {} if pk is None else {pk: val})


@dataclasses.dataclass
class Individual:
    genome: list[tuple[str, object]]
    fitness: float = 0.0

    def to_chain(self) -> list[OpSpec]:
        return [_spec(op, val) for op, val in self.genome]


def random_individual(rng: random.Random, length: int = 2) -> Individual:
    genome = []
    for _ in range(length):
        op = rng.choice(list(GENE_POOL))
        genome.append((op, rng.choice(list(GENE_POOL[op]))))
    return Individual(genome)


def mutate(ind: Individual, rng: random.Random, rate: float = 0.3) -> Individual:
    genome = list(ind.genome)
    for i, (op, val) in enumerate(genome):
        if rng.random() < rate:
            if rng.random() < 0.5:
                genome[i] = (op, rng.choice(list(GENE_POOL[op])))
            else:
                new_op = rng.choice(list(GENE_POOL))
                genome[i] = (new_op, rng.choice(list(GENE_POOL[new_op])))
    return Individual(genome)


def crossover(a: Individual, b: Individual, rng: random.Random) -> Individual:
    cut = rng.randint(0, min(len(a.genome), len(b.genome)))
    return Individual(a.genome[:cut] + b.genome[cut:])


#: the gene combos in GENE_POOL iteration order (JAX's branch table)
_GENE_COMBOS: list[tuple[str, object]] = [
    (op, val) for op, vals in GENE_POOL.items() for val in vals
]
_COMBO_INDEX = {c: i for i, c in enumerate(_GENE_COMBOS)}


def transform_genome(images_u8, individual: Individual,
                     generator: torch.Generator | None = None,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """The batch as ``fitness_fn`` transforms it: gene by gene, one one-op
    chain a gene in slot order, for a genome drawn from ``GENE_POOL``; the
    genome's whole chain otherwise. On ``device`` (None means "cuda",
    which raises without a GPU)."""
    dev = entry_device(device, "transform_genome")
    x = to_device(images_u8, dev)
    if all(g in _COMBO_INDEX for g in individual.genome):
        for op, val in individual.genome:
            x = build_chain_fn([_spec(op, val)], jit=False, device=dev)(x, generator)
        return x
    return build_chain_fn(individual.to_chain(), jit=False, device=dev)(x, generator)


def fitness_fn(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    to_model_space: Callable[[torch.Tensor], torch.Tensor],
    images_u8,
    individual: Individual,
    generator: torch.Generator | None = None,
    msp_threshold: float = 0.8,
    device: str | torch.device | None = None,
) -> float:
    """fitness = 1 / (1 + mean uncertainty); uncertainty = 1 if MSP < thr
    else 1 - MSP (cifar_image_transformations.py:177-201), of
    ``model_fn(to_model_space(transform_genome(...)))``; the forward in true
    f32. ``generator`` feeds the noise genes."""
    x = transform_genome(images_u8, individual, generator, device)
    with torch.no_grad(), full_f32():
        logits = model_fn(to_model_space(x))
        msp = torch.amax(torch.softmax(logits, dim=-1), dim=-1)
        unc = torch.where(msp < msp_threshold, 1.0, 1.0 - msp)
        return float(1.0 / (1.0 + torch.mean(unc)))


def evolutionary_search(
    model_fn,
    to_model_space,
    images_u8,
    population_size: int = 16,
    generations: int = 4,
    elite: int = 4,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Individual:
    """Find the transform chain that maximizes model confidence on the
    batch. The population evolves on ``random.Random(seed)`` as in JAX;
    each fitness is the module-level ``fitness_fn`` on ``device`` (None
    means "cuda", which raises without a GPU), its noise drawn from one
    generator seeded with ``seed``."""
    dev = entry_device(device, "evolutionary_search")
    x = to_device(images_u8, dev)
    rng = random.Random(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    pop = [random_individual(rng) for _ in range(population_size)]
    for _ in range(generations):
        for ind in pop:
            ind.fitness = fitness_fn(model_fn, to_model_space, x, ind, g, device=dev)
        pop.sort(key=lambda i: -i.fitness)
        nxt = pop[:elite]
        while len(nxt) < population_size - 2:
            a, b = rng.sample(pop[: max(elite * 2, 4)], 2)
            nxt.append(mutate(crossover(a, b, rng), rng))
        nxt += [random_individual(rng) for _ in range(population_size - len(nxt))]
        pop = nxt
    for ind in pop:
        ind.fitness = fitness_fn(model_fn, to_model_space, x, ind, g, device=dev)
    return max(pop, key=lambda i: i.fitness)
