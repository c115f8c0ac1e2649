"""Tests for the junk-filter device ops: repeat masking + block scoring.

The block-scoring oracle mirrors the observable per-block semantics of the
reference junk filter (telmer_pct / compute_rep decision thresholds) as an
independent pure-Python spec.
"""

import math

import numpy as np
import pytest

from fslr_tpu.config import JunkFilterConfig
from fslr_tpu.encode import batch_encode, decode
from fslr_tpu.ops import kmer_stats, tantan
from tests.oracles import random_seq

CFG = JunkFilterConfig()


# --- oracle: per-block scores, mirroring the reference spec ----------------

def rep_oracle(s: str) -> float:
    """Exponential-decay k-mer reuse score (spec of reference compute_rep)."""
    tot = 0.0
    seen = 0
    for k in (2, 3, 4, 5, 6):
        decay = 0.25 / k
        last = {}
        for i in range(len(s) - k):
            a = s[i:i + k]
            if a in last:
                amount = math.exp(-decay * (i - last[a] - 1))
            else:
                amount = 0.0
            if i > k:
                tot += amount
                seen += 1
            last[a] = i
    return tot / seen if seen else 0.0


def telmer_oracle(s: str) -> float:
    rot = kmer_stats.tel_rotations()
    cnt = sum(1 for i in range(len(s) - 5) if s[i:i + 6] in rot)
    return cnt / (len(s) - 5)


def _mk_batch(seqs, masks, L=1024):
    seq, lens = batch_encode(seqs, L)
    m = np.zeros((len(seqs), L), dtype=bool)
    for i, mm in enumerate(masks):
        m[i, :len(mm)] = mm[:L]
    return seq, lens, m


def test_block_scores_match_oracle():
    rng = np.random.default_rng(0)
    # read 0: one random block of 200 (should have high rep? no — random
    # seq has low rep) ; read 1: tandem repeat block (high rep);
    # read 2: telomeric block (high telmer)
    r0 = decode(random_seq(rng, 600))
    m0 = np.zeros(600, bool); m0[100:340] = True
    r1 = 'ACGT' * 30 + ('ATTGGC' * 45) + 'TTAC' * 30
    m1 = np.zeros(len(r1), bool); m1[120:120 + 270] = True
    r2 = 'GGTC' * 20 + ('TTAGGG' * 40) + 'CCAT' * 20
    m2 = np.zeros(len(r2), bool); m2[80:80 + 240] = True

    seq, lens, mask = _mk_batch([r0, r1, r2], [m0, m1, m2])
    junk, (blen, tel, rep, bid, bstart) = kmer_stats.junk_blocks_debug(
        seq, lens, mask, CFG)
    blen, tel, rep, bid = map(np.asarray, (blen, tel, rep, bid))
    junk = np.asarray(junk)

    runs = [(b, r) for r in range(len(blen)) if (b := bid[r]) >= 0
            and blen[r] > 0]
    assert len(runs) == 3
    blocks = {b: r for b, r in runs}
    subs = {0: r0[100:340].upper(), 1: r1[120:390].upper(),
            2: r2[80:320].upper()}
    for b, ridx in blocks.items():
        s = subs[b]
        assert blen[ridx] == len(s)
        assert abs(tel[ridx] - telmer_oracle(s)) < 1e-5, (b, tel[ridx],
                                                          telmer_oracle(s))
        assert abs(rep[ridx] - rep_oracle(s)) < 1e-3, (b, rep[ridx],
                                                       rep_oracle(s))

    # decisions: random block -> not junk (rep low); tandem repeat -> junk;
    # telomere block -> not junk (telmer high)
    assert not junk[0]
    assert junk[1]
    assert not junk[2]
    assert rep_oracle(subs[1]) >= 0.3
    assert telmer_oracle(subs[2]) > 0.3


def test_block_length_threshold():
    """Blocks of exactly 150 are NOT junk (reference: end-start > 150)."""
    r = 'ACGT' * 25 + 'AT' * 75 + 'GGCA' * 25
    m = np.zeros(len(r), bool)
    m[100:250] = True          # 150bp tandem block
    seq, lens, mask = _mk_batch([r], [m])
    junk = np.asarray(kmer_stats.junk_blocks(seq, lens, mask, CFG))
    assert not junk[0]
    m2 = np.zeros(len(r), bool)
    m2[99:250] = True          # 151bp
    seq, lens, mask = _mk_batch([r], [m2])
    junk = np.asarray(kmer_stats.junk_blocks(seq, lens, mask, CFG))
    assert junk[0]


def test_repeat_mask_finds_tandem():
    rng = np.random.default_rng(1)
    flank = decode(random_seq(rng, 300))
    rpt = 'ATTGGC' * 50                       # 300bp tandem repeat
    read = flank + rpt + decode(random_seq(rng, 300))
    seq, lens = batch_encode([read], 1024)
    mask = np.asarray(tantan.repeat_mask(seq, lens, CFG))
    core = mask[0, 320:580]                   # interior of the repeat
    assert core.mean() > 0.9, core.mean()
    outside = mask[0, :280].mean() + mask[0, 620:900].mean()
    assert outside < 0.1, outside


def test_repeat_mask_random_clean():
    rng = np.random.default_rng(2)
    reads = [decode(random_seq(rng, 800)) for _ in range(4)]
    seq, lens = batch_encode(reads, 1024)
    mask = np.asarray(tantan.repeat_mask(seq, lens, CFG))
    assert mask.mean() < 0.05, mask.mean()
