"""The paper's synthetic data generators, numpy only (copies of
``repro.data.synthetic``'s: the same draws from the same ``rng``):
Section 5.1's real-valued pairs, 5.1.3's correlated pairs, 5.3's
Zipf-skewed join-size tables and Fig. 9's TF-IDF documents."""
from __future__ import annotations

import numpy as np


def vector_pair(rng, n=100_000, nnz=20_000, overlap=0.1, outlier_frac=0.02,
                outlier_scale=10.0, binary=False):
    """Section 5.1: values U[-1, 1], ``outlier_frac`` outliers
    U[0, outlier_scale]; ``overlap`` of the nonzeros shared."""
    a = np.zeros(n, np.float32)
    b = np.zeros(n, np.float32)
    n_common = int(round(nnz * overlap))
    perm = rng.permutation(n)
    common = perm[:n_common]
    ia = np.concatenate([common, perm[n_common: nnz]])
    ib = np.concatenate([common, perm[nnz: 2 * nnz - n_common]])
    if binary:
        a[ia] = 1.0
        b[ib] = 1.0
        return a, b
    a[ia] = rng.uniform(-1, 1, nnz)
    b[ib] = rng.uniform(-1, 1, nnz)
    n_out = max(1, int(nnz * outlier_frac))
    a[rng.choice(ia, n_out, replace=False)] = rng.uniform(0, outlier_scale,
                                                          n_out)
    b[rng.choice(ib, n_out, replace=False)] = rng.uniform(0, outlier_scale,
                                                          n_out)
    return a, b


def correlated_pair(rng, n=100_000, nnz=20_000, overlap=0.1, rho=0.6):
    """Section 5.1.3: b's values on the overlap set by regression on a's,
    so their correlation there is about ``rho``."""
    a, b = vector_pair(rng, n, nnz, overlap)
    mask = (a != 0) & (b != 0)
    idx = np.nonzero(mask)[0]
    z = rng.standard_normal(len(idx)).astype(np.float32)
    sa = a[idx].std() + 1e-9
    b[idx] = rho * (a[idx] - a[idx].mean()) / sa + \
        np.sqrt(max(1 - rho ** 2, 0)) * z
    return a, b


def zipf_frequency_tables(rng, n_keys=30_000, rows_a=200_000,
                          rows_b=200_000, overlap=0.2, z=2.0):
    """TPC-H/Twitter-style join-size tables: key-frequency vectors with
    Zipf skew and partial key overlap."""
    keys = rng.permutation(n_keys)
    ka = keys[: n_keys // 2]
    n_shared = int(len(ka) * overlap)
    kb = np.concatenate([ka[:n_shared], keys[n_keys // 2:
                                             n_keys - n_shared]])
    fa = np.zeros(n_keys, np.float32)
    fb = np.zeros(n_keys, np.float32)
    draws_a = ka[np.minimum(rng.zipf(z, rows_a) - 1, len(ka) - 1)]
    draws_b = kb[np.minimum(rng.zipf(z, rows_b) - 1, len(kb) - 1)]
    np.add.at(fa, draws_a, 1.0)
    np.add.at(fb, draws_b, 1.0)
    return fa, fb


def tfidf_documents(rng, n_docs=200, vocab=50_000, doc_len_range=(100, 2000),
                    zipf_z=1.3):
    """TF-IDF-like document vectors (a 20-Newsgroups stand-in): Zipf
    unigram draws, tf * idf weighting, unit-normalized; (n_docs, vocab)
    float32."""
    dfs = np.zeros(vocab, np.float32)
    tf_list = []
    for _ in range(n_docs):
        L = rng.integers(*doc_len_range)
        words = np.minimum(rng.zipf(zipf_z, L) - 1, vocab - 1)
        tf = np.bincount(words, minlength=vocab).astype(np.float32)
        dfs += (tf > 0)
        tf_list.append(tf)
    idf = np.log((1 + n_docs) / (1 + dfs)) + 1
    docs = []
    for tf in tf_list:
        v = tf * idf
        nrm = np.linalg.norm(v)
        docs.append((v / max(nrm, 1e-9)).astype(np.float32))
    return np.stack(docs)
