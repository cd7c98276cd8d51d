"""Structure elucidation from spectra: spectra in, ranked molecules out
(port of ``diffspectra_tpu/api.py``'s ``Elucidator``, known-atom-count mode).

    from diffspectra_tpu_torch.api import Elucidator
    el = Elucidator.from_warm_state("artifacts/warm_qm9s_as.npz")
    result = el.elucidate({"uv": uv, "ir": ir, "raman": raman}, n_atoms=19)
    for c in result.candidates:
        print(c.frequency, c.molgraph.wl_hash())

All K draws of one request run as one batched reverse diffusion; the
spectra are encoded once. Candidates are ranked by consensus (how many
draws gave the same Weisfeiler-Lehman hash). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without CUDA they raise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import configs
from .data.info import get_dataset_info
from .diffusion.schedule import NoiseScheduleVP
from .evaluation.molgraph import MolGraph, consensus_rank, from_decoded
from .models.dmt import DMT
from .models.specformer import SPECTRUM_LENGTHS, used_spectra_indices
from .sampling.ancestral import AncestralSampler, make_time_steps
from .sampling.decode import mol_process, post_process
from .utils import masks as M
from .utils.scalers import get_data_inverse_scaler, get_self_cond_fn
from .warm_state import load_model_state, load_warm_state

SpectraInput = Union[np.ndarray, Sequence[np.ndarray], dict]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device}: the port runs on cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


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
    n_atoms: int

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
        self.sampler = AncestralSampler(
            self.noise_scheduler,
            make_time_steps(self.noise_scheduler, config.sampling.steps, 1e-3),
            config.model.pred_data,
            self_cond=config.model.self_cond,
            cond_process_fn=get_self_cond_fn(config),
            sampling_temperature=1.0,
        )
        self._inverse_scaler = get_data_inverse_scaler(config)

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

    @torch.no_grad()
    def elucidate(self, spectra: SpectraInput, n_atoms: Optional[int] = None,
                  num_candidates: int = 10, seed: int = 0,
                  normalized: bool = False) -> ElucidationResult:
        """Elucidate one molecule from its spectra, at a known atom count
        ``n_atoms`` (hydrogens included), with ``num_candidates`` draws."""
        if n_atoms is None:
            raise NotImplementedError(
                "elucidate(n_atoms=None), the marginal over atom counts, is not "
                "ported yet: see ROADMAP.md"
            )
        if num_candidates < 1:
            raise ValueError("num_candidates must be >= 1")
        max_n = int(self.config.data.max_node)
        if not 1 <= n_atoms <= max_n:
            raise ValueError(f"n_atoms must be in [1, {max_n}], got {n_atoms}")
        K, dev, cfg = num_candidates, self.device, self.config
        specs = [
            torch.from_numpy(np.tile(s[None], (K, 1))).to(dev)
            for s in self._prepare_context(spectra, normalized)
        ]
        # pad to the smallest bucket that fits
        buckets = tuple(sorted(cfg.eval.bucket_sizes)) or (max_n,)
        n_pad = next((b for b in buckets if b >= n_atoms), max_n)

        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        node_mask, edge_mask = M.build_masks(torch.full((K,), n_atoms, device=dev), n_pad)
        node_nf = cfg.data.atom_types + 1  # atom types, formal charge
        z = M.sample_combined_position_feature_noise(generator, K, n_pad, node_nf, node_mask)
        edge_z = M.sample_symmetric_edge_feature_noise(
            generator, K, n_pad, cfg.model.edge_ch, edge_mask
        )
        ctx = self.model.encode_context(specs)
        x, edge_x = self.sampler.sampling(
            self.model, generator, z, node_mask, edge_mask, edge_z, ctx
        )
        pos, one_hot, fc, edge_types = post_process(
            x, cfg.data.atom_types, node_mask, self._inverse_scaler, edge_x, edge_mask
        )
        mols = mol_process(one_hot, pos, fc, [n_atoms] * K, edge_types)
        return self._build_result(mols, K, n_atoms)

    def _build_result(self, mols, num_draws: int, n_atoms: int) -> ElucidationResult:
        """Consensus-rank decoded draws."""
        decoder = self.dataset_info["atom_decoder"]
        graphs = [from_decoded(m, decoder) for m in mols]
        candidates = [
            Candidate(
                molgraph=graphs[first], count=count, frequency=count / num_draws,
                first_draw=first, smiles=None, positions=np.asarray(mols[first][0]),
            )
            for _, count, first in consensus_rank(graphs)
        ]
        return ElucidationResult(candidates=candidates, num_draws=num_draws, n_atoms=n_atoms)
