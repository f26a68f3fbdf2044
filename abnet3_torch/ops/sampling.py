"""On-device pair sampling: the sampler's distributions live on the card
and each training step draws its own pair batch there.

The counterpart of ``abnet3_tpu/ops/sampling.py``. The P(type, speaker)
distributions of :class:`abnet3_torch.sampler.SamplerCluster` become
device tables: per sampling configuration a float32 CDF over its keys and
the (group 1, group 2) of each key, and one padded (type, speaker)-group
-> token-id table. A step draws a batch with a few tensor ops from an
explicit ``torch.Generator`` on the tables' device, so the host sends
nothing but a seed per call and no draw waits for the host.

The tables are built exactly as the JAX package builds them. The draw
does the JAX package's arithmetic on its raw random numbers
(:meth:`DevicePairSampler._draw_from`); only the raw numbers come from
torch's generator instead of ``jax.random``, which torch cannot
reproduce. The trainer seeds one generator a call of the sampled step
with :func:`call_seed` of (its seed, the epoch, the call): two runs with
one seed draw the same batches. :func:`chi_square_by_config` checks a
run of draws against the configurations' distributions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from abnet3_torch.utils import resolve_device

__all__ = ["DevicePairSampler", "CONFIGS", "call_seed",
           "chi_square_by_config"]

CONFIGS = ("Stype_Sspk", "Stype_Dspk", "Dtype_Sspk", "Dtype_Dspk")

#: the raw integers of a draw are uniform in [0, 2**30), as JAX draws them
_RAW_HIGH = 1 << 30
_SEED_PRIME = 1_000_003


def call_seed(seed: int, epoch: int, call: int) -> int:
    """The generator seed of one call of the sampled step:
    ``((seed * P + epoch) * P + call) mod 2**63`` with P = 1,000,003.
    The trainer numbers a pass's train calls from 0 and its dev calls
    from 10,000, as the JAX trainer folds its keys."""
    return ((int(seed) * _SEED_PRIME + int(epoch)) * _SEED_PRIME
            + int(call)) % (1 << 63)


class DevicePairSampler:
    """Sampler distributions compiled into device tables.

    ``descr``: cluster statistics from ``SamplerCluster.analyze_clusters``;
    ``proba``: per-config key -> probability dicts from
    ``SamplerCluster.type_speaker_sampling_p``; ``token_to_bank_id``:
    token index (into ``descr['tokens']``) -> TokenBank id (identity when
    the bank holds the tokens in descr order); ``batch_size``: pairs per
    batch, split across the configurations by ``ratio_same_diff_spk`` and
    ``ratio_same_diff_type`` (reference sampler.py:634-645). ``device``
    defaults to the card.

    ``group_table`` (groups, max group size) int32 and ``group_len``
    (groups,) int32 hold the token groups; ``configs`` lists the
    configurations that draw, each a dict with ``name``, ``n`` (pairs per
    batch), ``same_type``, ``same_group``, ``cdf`` float32 and ``g1``/``g2``
    int32 over its keys. All are on ``device``.
    """

    def __init__(self, descr, proba, batch_size=64, ratio_same_diff_spk=0.5,
                 ratio_same_diff_type=0.5, token_to_bank_id=None,
                 device=None):
        device = resolve_device(device)
        self.batch_size = batch_size
        self.device = device

        # token groups: (type, speaker) -> token ids, in first-seen order
        groups: Dict = {}
        for tok_id, (k, spk) in enumerate(zip(descr["tokens_type"],
                                              descr["tokens_speaker"])):
            groups.setdefault((int(k), spk), []).append(tok_id)
        gid = {key: i for i, key in enumerate(groups)}
        table = np.zeros((len(groups), max(len(v) for v in groups.values())),
                         np.int64)
        glen = np.zeros((len(groups),), np.int32)
        for i, toks in enumerate(groups.values()):
            if token_to_bank_id is not None:
                toks = [token_to_bank_id[t] for t in toks]
            table[i, :len(toks)] = toks
            glen[i] = len(toks)
        self.group_table = torch.from_numpy(table.astype(np.int32)).to(device)
        self.group_len = torch.from_numpy(glen).to(device)

        # the batch budget of each configuration
        num_same_spk = int(batch_size * (1 - ratio_same_diff_spk))
        num_diff_spk = batch_size - num_same_spk
        budget = {
            "Stype_Sspk": int(num_same_spk * (1 - ratio_same_diff_type)),
            "Dtype_Sspk": int(num_same_spk * ratio_same_diff_type),
            "Stype_Dspk": int(num_diff_spk * (1 - ratio_same_diff_type)),
            "Dtype_Dspk": int(num_diff_spk * ratio_same_diff_type),
        }
        self.configs: List[dict] = []
        for config in CONFIGS:
            dist = proba.get(config, {})
            keys = list(dist.keys())
            probs = np.asarray([dist[k] for k in keys], np.float64)
            if len(keys) == 0 or probs.sum() <= 0:
                continue
            cdf = np.cumsum(probs)
            cdf /= cdf[-1]
            g1 = np.zeros(len(keys), np.int32)
            g2 = np.zeros(len(keys), np.int32)
            for i, key in enumerate(keys):
                g1[i], g2[i] = _key_groups(config, key, gid)
            self.configs.append(dict(
                name=config, n=budget[config],
                same_type=config.startswith("Stype"),
                same_group=(config == "Stype_Sspk"),
                cdf=torch.from_numpy(cdf.astype(np.float32)).to(device),
                g1=torch.from_numpy(g1).to(device),
                g2=torch.from_numpy(g2).to(device)))
        if not self.configs:
            raise ValueError("no sampleable pair configuration")
        # a static batch size: the truncation leftovers and the budget of
        # configurations without keys top up the first configuration that
        # was given pairs (never a zero-ratio one), else the first one
        missing = batch_size - sum(c["n"] for c in self.configs)
        if missing:
            target = next((c for c in self.configs if c["n"] > 0),
                          self.configs[0])
            target["n"] += missing
        self.configs = [c for c in self.configs if c["n"] > 0]
        if not self.configs:
            raise ValueError("no sampleable pair configuration")

    def raws(self, generator: torch.Generator
             ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """The raw random numbers of one batch, drawn from ``generator``
        (on the tables' device): per configuration, in order, n uniforms
        in [0, 1) and two runs of n integers in [0, 2**30)."""
        out = []
        for c in self.configs:
            n = c["n"]
            u = torch.rand(n, generator=generator, device=self.device)
            r1 = torch.randint(0, _RAW_HIGH, (n,), generator=generator,
                               device=self.device)
            r2 = torch.randint(0, _RAW_HIGH, (n,), generator=generator,
                               device=self.device)
            out.append((u, r1, r2))
        return out

    def sample(self, generator: torch.Generator,
               with_speakers: bool = False):
        """Draw one pair batch on the device: (ids1, ids2, y) of shape
        (batch_size,), TokenBank ids (int64) and +1/-1 same/diff-type
        labels (float32); ``with_speakers=True`` appends the +1/-1
        same/diff-speaker labels, static per configuration (the
        Dtype_Dspk swap keeps its two speakers distinct)."""
        return self._draw_from(self.raws(generator), with_speakers)

    def _draw_from(self, raws: Sequence, with_speakers: bool = False):
        """The batch of :meth:`sample` from given raw numbers (one
        (u, r1, r2) per configuration, as :meth:`raws` draws them): the
        key by ``searchsorted(cdf, u, side='right')``, clipped; a token
        of each group by ``r % max(len, 1)``; within one group the second
        token ``r2 % max(len - 1, 1)``, shifted past the first and
        clamped into the group (a singleton group pairs its token with
        itself)."""
        out1, out2, ys, yspk = [], [], [], []
        for c, (u, raw1, raw2) in zip(self.configs, raws):
            dev = c["cdf"].device
            u = torch.as_tensor(u, device=dev)
            raw1 = torch.as_tensor(raw1, device=dev).long()
            raw2 = torch.as_tensor(raw2, device=dev).long()
            n_keys = c["cdf"].shape[0]
            idx = torch.clamp(torch.searchsorted(c["cdf"], u, right=True),
                              0, n_keys - 1)
            g1 = c["g1"][idx].long()
            g2 = c["g2"][idx].long()
            len1 = self.group_len[g1].long()
            len2 = self.group_len[g2].long()
            r1 = raw1 % torch.clamp(len1, min=1)
            if c["same_group"]:
                r2 = raw2 % torch.clamp(len1 - 1, min=1)
                r2 = torch.minimum(r2 + (r2 >= r1).long(), len1 - 1)
            else:
                r2 = raw2 % torch.clamp(len2, min=1)
            out1.append(self.group_table[g1, r1].long())
            out2.append(self.group_table[g2, r2].long())
            n = c["n"]
            ys.append(torch.full((n,), 1.0 if c["same_type"] else -1.0,
                                 device=dev))
            if with_speakers:
                yspk.append(torch.full(
                    (n,), 1.0 if c["name"].endswith("Sspk") else -1.0,
                    device=dev))
        out = (torch.cat(out1), torch.cat(out2), torch.cat(ys))
        if with_speakers:
            return out + (torch.cat(yspk),)
        return out


def _key_groups(config: str, key, gid) -> Tuple[int, int]:
    """(group 1, group 2) of one key of ``config``; a Dtype_Dspk key
    whose direct speaker assignment was never observed takes the swapped
    one (reference sampler.py:681-686)."""
    if config == "Stype_Sspk":
        spk, k = key
        return gid[(int(k), spk)], gid[(int(k), spk)]
    if config == "Stype_Dspk":
        spk1, spk2, k = key
        return gid[(int(k), spk1)], gid[(int(k), spk2)]
    if config == "Dtype_Sspk":
        spk, ki, kj = key
        return gid[(int(ki), spk)], gid[(int(kj), spk)]
    spk1, spk2, ki, kj = key
    if (int(ki), spk1) in gid and (int(kj), spk2) in gid:
        return gid[(int(ki), spk1)], gid[(int(kj), spk2)]
    return gid[(int(ki), spk2)], gid[(int(kj), spk1)]


def chi_square_by_config(sampler: DevicePairSampler, batches,
                         min_expected: float = 5.0):
    """Pearson's chi-square test of drawn batches against the sampler's
    distributions, one per configuration.

    ``batches``: (ids1, ids2, ...) batches of :meth:`DevicePairSampler
    .sample`. Each pair of a configuration's slice of a batch is counted
    under its (group 1, group 2); the expected count of a group pair is
    the number of draws times the summed probability of the keys that
    map to it. The group pairs, in the order of the configuration's
    keys, are gathered into consecutive bins of at least
    ``min_expected`` expected draws (the last bin takes the remainder),
    so a configuration with more keys than draws is still tested.
    Returns [{'name', 'draws', 'cells', 'chi2', 'dof', 'p'}, ...], with
    ``cells`` the number of bins."""
    from scipy.stats import chi2
    table = sampler.group_table.cpu().numpy()
    glen = sampler.group_len.cpu().numpy()
    group_of = {}
    for g in range(table.shape[0]):
        for t in table[g, :glen[g]]:
            group_of[int(t)] = g
    starts = np.cumsum([0] + [c["n"] for c in sampler.configs])
    batches = [(np.asarray(b[0].cpu()), np.asarray(b[1].cpu()))
               for b in batches]
    out = []
    for c, lo, hi in zip(sampler.configs, starts[:-1], starts[1:]):
        cdf = c["cdf"].cpu().numpy().astype(np.float64)
        probs = np.diff(np.concatenate([[0.0], cdf]))
        expected: Dict = {}
        for p, a, b in zip(probs, c["g1"].cpu().numpy(),
                           c["g2"].cpu().numpy()):
            expected[(int(a), int(b))] = expected.get((int(a), int(b)),
                                                      0.0) + p
        observed = dict.fromkeys(expected, 0)
        for ids1, ids2 in batches:
            for a, b in zip(ids1[lo:hi], ids2[lo:hi]):
                cell = (group_of[int(a)], group_of[int(b)])
                if cell not in observed:
                    raise AssertionError(f"{c['name']}: a pair of groups "
                                         f"{cell} that no key maps to")
                observed[cell] += 1
        draws = len(batches) * int(hi - lo)
        e_bins, o_bins = [], []
        e_acc = o_acc = 0.0
        for cell, p in expected.items():
            e_acc += p * draws
            o_acc += observed[cell]
            if e_acc >= min_expected:
                e_bins.append(e_acc)
                o_bins.append(o_acc)
                e_acc = o_acc = 0.0
        if e_bins:
            e_bins[-1] += e_acc
            o_bins[-1] += o_acc
        else:
            e_bins, o_bins = [e_acc], [o_acc]
        e, o = np.asarray(e_bins), np.asarray(o_bins)
        stat = float(((o - e) ** 2 / e).sum())
        dof = max(len(e) - 1, 1)
        out.append({"name": c["name"], "draws": draws, "cells": len(e),
                    "chi2": stat, "dof": dof,
                    "p": float(chi2.sf(stat, dof))})
    return out
