"""Profile-alignment kernel (POA core) vs full-band numpy oracle, and
POA-engine consensus quality (abpoa replacement semantics,
/root/reference/fslr/consensus_seq.py:32-37)."""

import numpy as np
import pytest

from fslr_tpu.config import ConsensusConfig, ScoringConfig
from fslr_tpu.encode import decode, encode
from fslr_tpu.ops import poa, profile_align as pa
from fslr_tpu.ops.banded import BW
from fslr_tpu.ops.ssw import first_gap_cost
from tests.oracles import mutate, random_seq

NEG = -1e30
SC = ScoringConfig(gap_open_is_first_base=False)
FG = first_gap_cost(SC)
EXT = float(SC.gap_extend)
OPENF = FG - EXT


def profile_banded_oracle(qcodes, scores, ext_c, qlen):
    """Band DP over (query row i, plane position p), band 0 <= p-i < BW.

    scores: (W, 4) float per-column substitution scores (already
    quantized); ext_c: (W,) per-column deletion extend costs.  Tie
    semantics mirror the kernel: per-lane earliest best row, then min
    lane, then min row among best lanes."""
    Lq, W = len(qcodes), len(scores)
    bestH = np.full(BW, NEG)
    bestI = np.zeros(BW, int)
    H_prev = np.full(W, NEG)
    E_prev = np.full(W, NEG)
    for i in range(Lq):
        H_row = np.full(W, NEG)
        E_row = np.full(W, NEG)
        F = NEG
        H_left = NEG            # H[i][p-1]
        for p in range(i, min(i + BW, W)):
            hp = H_prev[p] if p - (i - 1) < BW and i > 0 else (
                0.0 if i == 0 else NEG)
            # E: query gap (read base vs nothing)
            e_h = (H_prev[p] if i > 0 and p - (i - 1) < BW else
                   (0.0 if i == 0 else NEG))
            e_e = E_prev[p] if i > 0 and p - (i - 1) < BW else NEG
            E_row[p] = max(e_e - EXT, e_h - FG)
            # diag
            diag_h = (H_prev[p - 1] if i > 0 and p - 1 >= i - 1
                      and (p - 1) - (i - 1) < BW else (0.0 if i == 0
                                                       else NEG))
            if i == 0:
                diag_h = 0.0
            b = qcodes[i]
            s = scores[p, b] if b < 4 else pa.PAD_BYTE / pa.SCALE
            Hno = max(0.0, diag_h + s, E_row[p])
            F = max(F - ext_c[p], H_left - OPENF - ext_c[p])
            H_row[p] = max(Hno, F)
            H_left = H_row[p]
            l = p - i
            if i < qlen and H_row[p] > bestH[l]:
                bestH[l] = H_row[p]
                bestI[l] = i
        H_prev, E_prev = H_row, E_row
    score = max(bestH.max(), 0.0)
    if score <= 0:
        return 0.0, 0, 0
    lanes = np.nonzero(bestH == score)[0]
    lane = lanes.min()
    qend = min(bestI[l] for l in lanes)
    return float(score), int(qend), int(lane)


def _random_case(rng, Lq, W):
    qcodes = random_seq(rng, rng.integers(Lq // 2, Lq))
    counts = rng.integers(0, 4, size=(W - 160, 4)).astype(np.float32)
    # embed a mutated copy of the read as the dominant profile signal
    emb = mutate(rng, qcodes, sub=0.1, indel=0.03)
    start = 40
    for t, b in enumerate(emb[:W - 160 - start]):
        counts[start + t] = 0
        counts[start + t, b] = 5
    support = counts.sum(1)
    sc = counts @ np.where(np.eye(4, dtype=bool), 2.0, -3.0)
    sc /= np.maximum(support, 1)[:, None]
    q8 = np.clip(np.rint(sc * pa.SCALE), -127, 127).astype(np.int64)
    q8[support == 0] = pa.PAD_BYTE
    scores = np.full((W, 4), pa.PAD_BYTE / pa.SCALE, np.float64)
    scores[poa.PROFILE_OFFSET:poa.PROFILE_OFFSET + len(q8)] = \
        q8[:W - poa.PROFILE_OFFSET] / pa.SCALE
    ext_c = np.full(W, EXT, np.float64)
    cov = np.clip(support / 5.0, 1 / 16, 1.0)
    ext_c[poa.PROFILE_OFFSET:poa.PROFILE_OFFSET + len(q8)] = \
        (EXT * cov)[:W - poa.PROFILE_OFFSET]
    b = (q8 & 0xFF).astype(np.uint32)
    packed = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
              | (b[:, 3] << 24)).astype(np.uint32)
    sp = np.full(W, np.uint32(0x80808080), np.uint32)
    sp[poa.PROFILE_OFFSET:poa.PROFILE_OFFSET + len(q8)] = \
        packed[:W - poa.PROFILE_OFFSET]
    g = np.cumsum(ext_c).astype(np.float32)
    return qcodes, scores, ext_c, sp.view(np.int32), g


def test_profile_kernel_matches_oracle():
    rng = np.random.default_rng(3)
    Lq = 256
    W = Lq + 256
    n = 4
    q = np.full((n, Lq), 4, np.uint8)
    sp = np.empty((n, W), np.int32)
    g = np.empty((n, W), np.float32)
    qlens = np.zeros(n, np.int32)
    cases = []
    for r in range(n):
        qcodes, scores, ext_c, sp_r, g_r = _random_case(rng, Lq, W)
        q[r, :len(qcodes)] = qcodes
        qlens[r] = len(qcodes)
        sp[r] = sp_r
        g[r] = g_r
        cases.append((qcodes, scores, ext_c))
    score, qend, lane, bits = pa.profile_banded_tb(q, sp, g, qlens, SC)
    score = np.asarray(score)
    qend = np.asarray(qend)
    lane = np.asarray(lane)
    for r, (qcodes, scores, ext_c) in enumerate(cases):
        os_, oq, ol = profile_banded_oracle(qcodes, scores, ext_c,
                                            len(qcodes))
        assert abs(float(score[r]) - os_) < 1e-3, (r, float(score[r]), os_)
        assert int(qend[r]) == oq and int(lane[r]) == ol, \
            (r, int(qend[r]), oq, int(lane[r]), ol)


def test_profile_walk_path_rescoring():
    """The traceback path must re-score to the kernel's score exactly."""
    rng = np.random.default_rng(11)
    Lq = 256
    W = Lq + 256
    n = 6
    q = np.full((n, Lq), 4, np.uint8)
    sp = np.empty((n, W), np.int32)
    g = np.empty((n, W), np.float32)
    qlens = np.zeros(n, np.int32)
    cases = []
    for r in range(n):
        qcodes, scores, ext_c, sp_r, g_r = _random_case(rng, Lq, W)
        q[r, :len(qcodes)] = qcodes
        qlens[r] = len(qcodes)
        sp[r] = sp_r
        g[r] = g_r
        cases.append((qcodes, scores, ext_c))
    score, qend, lane, qstart, l_fin, cigars = pa.profile_align_walk(
        q, sp, g, qlens, SC)
    for r, (qcodes, scores, ext_c) in enumerate(cases):
        qi = int(qstart[r])
        p = qi + int(l_fin[r])           # plane position of path start
        total = 0.0
        for nrun, op in cigars[r]:
            if op == 'M':
                for t in range(nrun):
                    b = qcodes[qi + t]
                    total += (scores[p + t, b] if b < 4
                              else pa.PAD_BYTE / pa.SCALE)
                qi += nrun
                p += nrun
            elif op == 'I':
                total -= FG + (nrun - 1) * EXT
                qi += nrun
            elif op == 'D':
                total -= OPENF + ext_c[p:p + nrun].sum()
                p += nrun
        assert abs(total - float(score[r])) < 1e-3, (r, total,
                                                     float(score[r]))
        assert qi - 1 == int(qend[r])


def test_poa_identical_members_is_backbone():
    rng = np.random.default_rng(0)
    seq = decode(random_seq(rng, 600))
    cons = poa.consensus_sequences([[seq] * 5],
                                   ConsensusConfig(engine='poa'))
    assert cons[0] == seq


def _edit(a, b):
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ai != b[j - 1]))
        prev = cur
    return prev[lb]


def test_poa_beats_pileup_on_noisy_cluster():
    rng = np.random.default_rng(1)
    original = random_seq(rng, 500)
    ostr = decode(original)
    members = [decode(mutate(rng, original, sub=0.05, indel=0.02))
               for _ in range(9)]
    cpo = poa.consensus_sequences([members], ConsensusConfig(engine='poa'))[0]
    cpi = poa.consensus_sequences([members],
                                  ConsensusConfig(engine='pileup'))[0]
    e_po, e_pi = _edit(cpo, ostr), _edit(cpi, ostr)
    assert e_po <= 5, e_po
    assert e_po <= e_pi, (e_po, e_pi)


def test_poa_recovers_majority_insertion():
    """An insertion shared by most members (absent from the backbone) must
    appear in the consensus even when its observed copies differ — the
    case whole-string insertion voting can drop."""
    rng = np.random.default_rng(5)
    base = random_seq(rng, 300)
    ins = random_seq(rng, 12)
    with_ins = np.concatenate([base[:150], ins, base[150:]])
    members = [decode(base)]          # backbone lacks the insertion
    for _ in range(8):
        members.append(decode(mutate(rng, with_ins, sub=0.06, indel=0.02)))
    cons = poa.consensus_sequences([members],
                                   ConsensusConfig(engine='poa'))[0]
    assert _edit(cons, decode(with_ins)) <= 4
    # and the insertion content itself must be present
    assert _edit(cons[140:175], decode(with_ins[140:175])) <= 3


def test_poa_multiple_clusters_batched():
    rng = np.random.default_rng(2)
    clusters = []
    originals = []
    for _ in range(3):
        orig = random_seq(rng, 400)
        originals.append(orig)
        clusters.append([decode(mutate(rng, orig, sub=0.04, indel=0.01))
                        for _ in range(5)])
    clusters.append([])
    cons = poa.consensus_sequences(clusters, ConsensusConfig(engine='poa'))
    assert cons[3] == ''
    for c, orig in zip(cons[:3], originals):
        assert _edit(c, decode(orig)) <= 8
