"""The plain reference against hand-made cases on the CPU, and the judge
of a sound run of the program's plain versions."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from pbcore import reference as ref


def test_decode_of_one_hand_packed_byte():
    # Codes 00, 01, 10, 11 for individuals 0..3: 0b11_10_01_00.
    a, b = ref.decode(torch.tensor([[0b11100100]], dtype=torch.uint8),
                      torch.float64)
    assert a.tolist() == [[2.0, 0.0, 1.0, 0.0]]
    assert b.tolist() == [[1.0, 0.0, 1.0, 1.0]]


def test_to_planes_puts_individual_4j_plus_k_in_plane_k():
    v = torch.arange(10, dtype=torch.float64)
    p = ref.to_planes(v, 4).reshape(4, 4)
    assert p[1].tolist() == [1.0, 5.0, 9.0, 0.0]
    assert p[3].tolist() == [3.0, 7.0, 0.0, 0.0]


def small_inputs(seed=3, n=64, m=16, T=2, B=8, wave=1):
    rng = np.random.default_rng(seed)
    bed = torch.tensor(rng.integers(0, 256, (m, n // 4)), dtype=torch.uint8)
    bed[bed == 0x55] = 0
    na = torch.ones((T, n), dtype=torch.float64)
    na[1, ::7] = 0
    inp = ref.Inputs(bed=bed, na=ref.to_planes(na, n // 4), nonas=na.sum(1),
                     group_of=torch.zeros(m, dtype=torch.int64),
                     mtotgrp=torch.tensor([m]),
                     cva=torch.tensor([[0.0, 1e-3, 1e-2, 1e-1]],
                                      dtype=torch.float64),
                     n_total=n, m_local=m, block_size=B, wave=wave)
    return inp, rng


def test_marker_stats_by_numpy():
    inp, _ = small_inputs()
    mave, msig = ref.marker_stats(inp, torch.float64)
    a, b = ref.decode(inp.bed, torch.float64)
    for t in range(2):
        w = inp.na[t].numpy() > 0
        for j in range(inp.m_local):
            x = a[j].numpy()[w & (b[j].numpy() > 0)]
            assert mave[t, j] == pytest.approx(x.mean())
            dev = a[j].numpy()[w] - x.mean() * b[j].numpy()[w]
            sd = np.sqrt((dev ** 2).sum() / (w.sum() - 1))
            assert msig[t, j] == pytest.approx(1 / sd)


@pytest.mark.parametrize("wave", [1, 4])
def test_block_scan_against_a_direct_gibbs_loop(wave):
    """One block, markers in order, each drawn against the residual as its
    wave found it: the reference's Gram form against x_j . eps."""
    inp, rng = small_inputs(wave=wave)
    mave, msig = ref.marker_stats(inp, torch.float64)
    T, B = 2, 8
    a, b = ref.decode(inp.bed[:B], torch.float64)
    x = (a[None] - mave[:, :B, None] * b[None]) * msig[:, :B, None]   # (T, B, N)
    na = inp.na
    eps = torch.tensor(rng.normal(size=(T, na.shape[1]))) * na
    beta = torch.tensor(rng.normal(0, 0.05, (T, B)))
    sigmag = torch.tensor([[0.3], [0.2]], dtype=torch.float64)
    sigmae = torch.tensor([0.6, 0.7], dtype=torch.float64)
    pi = torch.tensor([[[0.4, 0.3, 0.2, 0.1]]] * T, dtype=torch.float64)
    lc, rd, sqb = ref.tables(sigmag, sigmae, pi, inp.cva, inp.nonas,
                             float(inp.n_total), torch.float64)
    u = torch.tensor(rng.random((T, B)))
    z = torch.tensor(rng.normal(size=(T, B)))
    gram = torch.einsum("tjn,tn,tkn->tjk", x, na, x)
    c = torch.einsum("tjn,tn->tj", x, eps)
    nm1 = inp.nonas[:, None] - 1
    live = torch.ones((T, B), dtype=torch.bool)
    res = ref.scan((c + beta * nm1)[None], lc[:, 0].T[None, :, :, None]
                   .expand(1, 4, T, B), rd[:, 0].T[None, :, :, None]
                   .expand(1, 4, T, B), sqb[:, 0].T[None, :, :, None]
                   .expand(1, 4, T, B), gram[None], beta[None],
                   torch.zeros((1, T, B), dtype=torch.int32),
                   torch.zeros((1, T, B), dtype=torch.float64), u[None],
                   z[None], live[None], ~live[None], 1 / (2 * sigmae), wave)
    # Direct: per trait, per wave, num_j = x_j . (eps + x_j beta_j) with
    # eps as the wave found it.
    for t in range(T):
        e = eps[t].clone()
        bt = beta[t].clone()
        for w0 in range(0, B, wave):
            e_wave = e.clone()
            for j in range(w0, w0 + wave):
                num = float(x[t, j] @ (e_wave * na[t])) + float(bt[j]) * float(nm1[t, 0])
                L = np.array([float(lc[t, 0, k] + num * num * rd[t, 0, k] / (2 * sigmae[t]))
                              for k in range(4)])
                p = np.exp(L - L.max())
                cdf = np.cumsum(p / p.sum())
                k = int(np.argmax(float(u[t, j]) <= cdf))
                new = 0.0 if k == 0 else num * float(rd[t, 0, k]) + float(sqb[t, 0, k] * z[t, j])
                assert int(res["comp_new"][0, t, j]) == k
                assert float(res["beta_new"][0, t, j]) == pytest.approx(new, rel=1e-9, abs=1e-12)
                e += x[t, j] * (float(bt[j]) - new) * na[t]
                bt[j] = new


def test_a_sound_run_of_the_plain_versions_is_correct():
    from pbcore import drive, judge
    c = tiny_cell()
    r = drive.run(c, 2 ** 31 + 11, 0.5, False, device="cpu",
                  log=lambda *a: None)
    assert judge.correct({k: v for k, v in r["checks"].items()
                          if not k.startswith("_")}), r["checks"]
    assert r["iterations"] >= 1 and r["records_s"] is not None
