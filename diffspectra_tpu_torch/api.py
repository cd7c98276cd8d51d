"""Structure elucidation from spectra: spectra in, ranked molecules out
(port of ``diffspectra_tpu/api.py``'s ``Elucidator``).

    from diffspectra_tpu_torch.api import Elucidator
    el = Elucidator.from_warm_state("artifacts/warm_qm9s_as.npz")
    result = el.elucidate({"uv": uv, "ir": ir, "raman": raman}, n_atoms=19)
    for c in result.candidates:
        print(c.frequency, c.molgraph.wl_hash())

All K draws of one request run as one batched reverse diffusion (one
*round*); the spectra are encoded once per round. Candidates are ranked by
consensus (how many draws gave the same Weisfeiler-Lehman hash). Without
``n_atoms`` the count is marginalised: over the counts a count head
predicts (``load_count_head``) or the train histogram's plausible counts.
``elucidate_batch`` packs many queries into each round. The sampler is
``config.sampling.method``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without CUDA they raise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import configs
from .data.info import get_dataset_info
from .device import resolve_device
from .diffusion.schedule import NoiseScheduleVP
from .evaluation.molgraph import MolGraph, consensus_rank, from_decoded
from .models import atom_count
from .models.dmt import DMT
from .models.specformer import SPECTRUM_LENGTHS, used_spectra_indices
from .sampling.decode import mol_process
from .sampling.harness import bucket_for, bucket_sizes_of, make_sampler, sample_round
from .utils.scalers import get_data_inverse_scaler
from .warm_state import load_model_state, load_warm_state

SpectraInput = Union[np.ndarray, Sequence[np.ndarray], dict]


def load_dmt(npz_path: str, config, device=None) -> DMT:
    """The DMT of ``config`` with the EMA weights and batch statistics of a
    warm-state export, in eval mode on ``device``."""
    device = resolve_device(device)
    model = DMT.from_config(config)
    load_model_state(model, load_warm_state(npz_path)["variables"])
    return model.eval().to(device)


@dataclasses.dataclass
class Candidate:
    """One distinct elucidated structure."""

    molgraph: MolGraph
    count: int  # draws that produced this structure
    frequency: float  # count / num_draws
    first_draw: int  # index of the first draw that produced it
    smiles: Optional[str]  # always None: the port has no RDKit
    positions: Optional[np.ndarray]  # [n_atoms, 3] conformer of the first draw


@dataclasses.dataclass
class ElucidationResult:
    candidates: List[Candidate]  # consensus-ranked, best first
    num_draws: int
    # the atom count the draws were conditioned on; None when it was
    # marginalised (each candidate then carries its own size)
    n_atoms: Optional[int]

    @property
    def best(self) -> Optional[Candidate]:
        return self.candidates[0] if self.candidates else None


class Elucidator:
    """Conditional-diffusion structure elucidation with the EMA weights."""

    def __init__(self, config, model: DMT, device: torch.device):
        self.config = config
        self.model = model
        self.device = device
        self.dataset_info = get_dataset_info(config.data.info_name)
        self.noise_scheduler = NoiseScheduleVP(config.sde.schedule)
        self.sampler = make_sampler(config, self.noise_scheduler)
        self._inverse_scaler = get_data_inverse_scaler(config)
        self._count_head = None  # set by load_count_head

    @classmethod
    def from_warm_state(cls, npz_path: str, config=None, overrides: Optional[dict] = None,
                        device=None) -> "Elucidator":
        """Load a warm-state export (``artifacts/warm_*.npz``)."""
        device = resolve_device(device)
        config = configs.apply_overrides(config or configs.get_config(), overrides)
        return cls(config, load_dmt(npz_path, config, device), device)

    def _prepare_context(self, spectra: SpectraInput, normalized: bool):
        """One molecule's spectra as a tuple of ``[L]`` arrays in the order
        uv, ir, raman, normalised with log10(x + 1) unless ``normalized``."""
        version = self.config.data.spectra_version
        idx = used_spectra_indices(version)
        names = ("uv", "ir", "raman")
        if isinstance(spectra, dict):
            arrays = [np.asarray(spectra[names[i]], np.float32) for i in idx]
        elif isinstance(spectra, (list, tuple)):
            arrays = [np.asarray(s, np.float32) for s in spectra]
        else:
            arrays = [np.asarray(spectra, np.float32)]
        if len(arrays) != len(idx):
            raise ValueError(
                f"spectra_version={version} expects {len(idx)} spectra "
                f"({[names[i] for i in idx]}), got {len(arrays)}"
            )
        out = []
        for a, i in zip(arrays, idx):
            if a.shape != (SPECTRUM_LENGTHS[i],):
                raise ValueError(
                    f"{names[i]} spectrum must have shape ({SPECTRUM_LENGTHS[i]},), got {a.shape}"
                )
            out.append(a if normalized else np.log10(a + 1.0))
        return tuple(out)

    def _bucket(self, n_atoms: int) -> int:
        """The smallest configured bucket that holds ``n_atoms``, else
        ``data.max_node``."""
        return bucket_for(bucket_sizes_of(self.config, pad_to_max=True), n_atoms)

    def _sample_n_atoms(self, rng: np.random.Generator) -> int:
        """One atom count from the train histogram (numpy, as in JAX)."""
        hist = self.dataset_info["train_n_nodes"]
        ks = np.array(sorted(hist.keys()))
        ps = np.array([hist[k] for k in ks], dtype=np.float64)
        return int(rng.choice(ks, p=ps / ps.sum()))

    @torch.no_grad()
    def _round(self, contexts, n_atoms: Sequence[int], n_pad: int, generator):
        """One batched reverse diffusion: draw ``d`` conditioned on the
        spectra ``contexts[d]`` (a tuple of ``[L]`` arrays) at ``n_atoms[d]``
        atoms, padded to ``n_pad``; returns the decoded molecules."""
        dev = self.device
        specs = [torch.from_numpy(np.stack([c[s] for c in contexts])).to(dev)
                 for s in range(len(contexts[0]))]
        n_nodes = torch.tensor(list(n_atoms), device=dev)
        pos, one_hot, fc, edge_types = sample_round(
            self.model, self.sampler, self.config, self._inverse_scaler, specs, n_nodes, n_pad,
            generator)
        return mol_process(one_hot, pos, fc, list(n_atoms), edge_types)

    def _generator(self, seed: int) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return generator

    def load_count_head(self, path: str) -> dict:
        """Attach a trained atom-count head (``artifacts/atom_count_head.npz``):
        ``elucidate(n_atoms=None)`` then samples only the few counts the
        spectrum supports. Returns the head's training metadata. A head for
        another largest atom count than ``data.max_node`` raises."""
        head, meta = atom_count.load_head(path, self.device)
        max_n = int(self.config.data.max_node)
        if head.max_n != max_n:
            raise ValueError(f"{path}: the count head predicts counts up to {head.max_n}, "
                             f"the model serves up to data.max_node={max_n}")
        self._count_head = head
        return meta

    @torch.no_grad()
    def _predict_counts(self, context, coverage: float = 0.9, cap: int = 4):
        """``(counts, {count: probability})`` for one prepared context."""
        specs = [torch.from_numpy(s[None]).to(self.device) for s in context]
        emb = atom_count.encode_spec_pooled(self.model, specs)
        probs = atom_count.predict_count_probs(self._count_head, emb).cpu().numpy()
        (counts, ps), = atom_count.top_counts(probs, coverage=coverage, cap=cap)
        return counts, dict(zip(counts, ps))

    def _plausible_n(self, coverage: float = 0.95, cap: int = 16) -> List[int]:
        """The smallest prior-sorted set of atom counts covering ``coverage``
        of the train histogram (at most ``cap``), ascending."""
        hist = self.dataset_info["train_n_nodes"]
        max_n = int(self.config.data.max_node)
        items = sorted(((k, v) for k, v in hist.items() if 1 <= k <= max_n),
                       key=lambda kv: -kv[1])
        total = sum(v for _, v in items) or 1
        out, acc = [], 0.0
        for k, v in items:
            out.append(int(k))
            acc += v / total
            if acc >= coverage or len(out) >= cap:
                break
        return sorted(out)

    def elucidate(self, spectra: SpectraInput, n_atoms: Optional[int] = None,
                  num_candidates: int = 10, seed: int = 0, normalized: bool = False,
                  draws_per_n: Optional[int] = None) -> ElucidationResult:
        """Elucidate one molecule from its spectra with ``num_candidates``
        draws at ``n_atoms`` atoms (hydrogens included). With
        ``n_atoms=None`` the count is marginalised: each count the head
        predicts (or, without a head, each plausible count of the train
        histogram) gets ``draws_per_n`` draws (default
        ``max(2, num_candidates // #counts)``), consensus ranks all draws
        together, and ties break toward the likelier count; the result's
        ``n_atoms`` is then None."""
        if num_candidates < 1:
            raise ValueError("num_candidates must be >= 1")
        if n_atoms is None:
            return self._elucidate_marginal(spectra, num_candidates, seed, normalized,
                                            draws_per_n)
        max_n = int(self.config.data.max_node)
        if not 1 <= n_atoms <= max_n:
            raise ValueError(f"n_atoms must be in [1, {max_n}], got {n_atoms}")
        context = self._prepare_context(spectra, normalized)
        mols = self._round([context] * num_candidates, [n_atoms] * num_candidates,
                           self._bucket(n_atoms), self._generator(seed))
        return self._build_result(mols, num_candidates, n_atoms)

    def _elucidate_marginal(self, spectra, num_candidates, seed, normalized, draws_per_n):
        """One round per candidate count, consensus across all draws."""
        context = self._prepare_context(spectra, normalized)
        if self._count_head is not None:
            ns, prior = self._predict_counts(context)
        else:
            ns = self._plausible_n()
            hist = self.dataset_info["train_n_nodes"]
            total = sum(hist.values()) or 1
            prior = {int(k): v / total for k, v in hist.items()}
        K = draws_per_n or max(2, num_candidates // max(1, len(ns)))
        generator = self._generator(seed)
        mols = []
        for n in ns:
            mols.extend(self._round([context] * K, [n] * K, self._bucket(n), generator))
        return self._build_result(mols, K * len(ns), None, n_prior=prior)

    def elucidate_batch(self, spectra_list: Sequence[SpectraInput],
                        n_atoms_list: Optional[Sequence[Optional[int]]] = None,
                        num_candidates: int = 10, seed: int = 0, normalized: bool = False,
                        queries_per_round: int = 8) -> List[ElucidationResult]:
        """Serve many queries, ``queries_per_round`` x ``num_candidates``
        draws a round, each round at one bucket; the last round of a bucket
        is padded by repeating its last query and the surplus rows are
        dropped after decoding. A ``None`` atom count draws one count from
        the train histogram (numpy ``default_rng(seed)``, as in JAX).
        Results come back in input order."""
        if num_candidates < 1:
            raise ValueError("num_candidates must be >= 1")
        q = len(spectra_list)
        n_atoms_list = [None] * q if n_atoms_list is None else list(n_atoms_list)
        if len(n_atoms_list) != q:
            raise ValueError("n_atoms_list length must match spectra_list")
        host_rng = np.random.default_rng(seed)
        max_n = int(self.config.data.max_node)
        n_atoms, contexts = [], []
        for spec, na in zip(spectra_list, n_atoms_list):
            na = self._sample_n_atoms(host_rng) if na is None else int(na)
            if not 1 <= na <= max_n:
                raise ValueError(f"n_atoms must be in [1, {max_n}], got {na}")
            n_atoms.append(na)
            contexts.append(self._prepare_context(spec, normalized))

        by_pad: dict = {}
        for i, na in enumerate(n_atoms):
            by_pad.setdefault(self._bucket(na), []).append(i)
        results: List[Optional[ElucidationResult]] = [None] * q
        generator = self._generator(seed)
        K = num_candidates
        for n_pad, idxs in sorted(by_pad.items()):
            for start in range(0, len(idxs), queries_per_round):
                chunk = idxs[start : start + queries_per_round]
                full = chunk + [chunk[-1]] * (queries_per_round - len(chunk))
                mols = self._round([contexts[i] for i in full for _ in range(K)],
                                   [n_atoms[i] for i in full for _ in range(K)],
                                   n_pad, generator)
                for slot, qi in enumerate(chunk):
                    results[qi] = self._build_result(mols[slot * K : (slot + 1) * K], K,
                                                     n_atoms[qi])
        return results  # type: ignore[return-value]

    def _build_result(self, mols, num_draws: int, n_atoms: Optional[int],
                      n_prior: Optional[dict] = None) -> ElucidationResult:
        """Consensus-rank decoded draws; with ``n_prior`` ({n: probability})
        equal counts rank by the probability of their own atom count."""
        decoder = self.dataset_info["atom_decoder"]
        graphs = [from_decoded(m, decoder) for m in mols]
        ranked = consensus_rank(graphs)
        if n_prior is not None:
            ranked = sorted(ranked, key=lambda r: (
                -r[1], -float(n_prior.get(graphs[r[2]].n_atoms, 0.0)), r[2]))
        candidates = [
            Candidate(
                molgraph=graphs[first], count=count, frequency=count / num_draws,
                first_draw=first, smiles=None, positions=np.asarray(mols[first][0]),
            )
            for _, count, first in ranked
        ]
        return ElucidationResult(candidates=candidates, num_draws=num_draws, n_atoms=n_atoms)
