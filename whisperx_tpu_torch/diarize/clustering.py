"""Speaker clustering over embedding vectors.

Counterpart of ``whisperx_tpu/diarize/clustering.py``, kept as its own copy
with the same iteration and tie-breaking order, so that labels come out
identical. Host-side (tiny data: one embedding per ~2 s window or per
(window, local speaker)), numpy-only: average-linkage cosine AHC with
num/min/max speaker and cannot-link constraints, and spectral clustering.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cosine_distance_matrix(x: np.ndarray) -> np.ndarray:
    normed = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    return 1.0 - normed @ normed.T


def agglomerative_cluster(
    embeddings: np.ndarray,
    *,
    num_clusters: Optional[int] = None,
    min_clusters: int = 1,
    max_clusters: Optional[int] = None,
    threshold: float = 0.35,
    cannot_link=None,
    distances: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Average-linkage AHC on cosine distance. Returns labels [N].

    Stops at ``num_clusters`` if given; otherwise merges while the closest
    pair is under ``threshold``, clamped to [min_clusters, max_clusters].

    ``distances``: optional precomputed [N, N] distance matrix replacing
    the cosine default — e.g. negated PLDA log-likelihood ratios
    (diarize/plda.py), where ``threshold=0.0`` makes every merge the
    Bayes same/different-speaker decision.

    ``cannot_link``: iterable of (i, j) item-index pairs that must end in
    DIFFERENT clusters — e.g. two local speakers active in the same
    segmentation window are necessarily different people. Infeasible
    merges are skipped (their pair distance is poisoned to inf), which
    also means ``num_clusters`` below the constraint-implied minimum
    cannot be honored exactly.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)

    forbid = np.zeros((n, n), bool)
    for i, j in cannot_link or ():
        forbid[i, j] = forbid[j, i] = True

    if distances is not None:
        dist = np.array(distances, np.float64)
        if dist.shape != (n, n):
            raise ValueError(
                f"distances must be [{n}, {n}], got {dist.shape}"
            )
    else:
        dist = cosine_distance_matrix(embeddings)
    np.fill_diagonal(dist, np.inf)
    clusters = {i: [i] for i in range(n)}
    # cluster-level distance matrix (average linkage), updated in place;
    # constraint-violating pairs are unmergeable from the start
    cd = np.where(forbid, np.inf, dist)
    active = set(range(n))

    def target_reached() -> bool:
        k = len(active)
        if num_clusters is not None:
            return k <= num_clusters
        if k <= min_clusters:
            return True
        return False

    while len(active) > 1 and not target_reached():
        ids = sorted(active)
        sub = cd[np.ix_(ids, ids)]
        i_loc, j_loc = np.unravel_index(np.argmin(sub), sub.shape)
        best = sub[i_loc, j_loc]
        if not np.isfinite(best):
            break  # every remaining merge violates a cannot-link
        a, b = ids[i_loc], ids[j_loc]
        must_merge = (
            (num_clusters is not None and len(active) > num_clusters)
            or (max_clusters is not None and len(active) > max_clusters)
        )
        if not must_merge and best > threshold:
            break
        # merge b into a (average linkage over member pairs); the merged
        # cluster inherits BOTH members' cannot-links
        clusters[a].extend(clusters[b])
        active.discard(b)
        for c in active:
            if c == a:
                continue
            if forbid[np.ix_(clusters[a], clusters[c])].any():
                cd[a, c] = cd[c, a] = np.inf
                continue
            pair = dist[np.ix_(clusters[a], clusters[c])]
            cd[a, c] = cd[c, a] = pair.mean()
        cd[b, :] = cd[:, b] = np.inf

    labels = np.zeros(n, np.int32)
    for new_id, cid in enumerate(sorted(active)):
        labels[clusters[cid]] = new_id
    return labels


def spectral_cluster(
    embeddings: np.ndarray,
    *,
    num_clusters: Optional[int] = None,
    min_clusters: int = 1,
    max_clusters: Optional[int] = None,
    threshold: float = 0.35,
    cannot_link: Optional[list] = None,
) -> np.ndarray:
    """Spectral (normalized-cuts style) clustering on the cosine-affinity
    graph — the scoring alternative from ROADMAP to average-linkage AHC.

    Speaker count: when ``num_clusters`` is None, k = number of connected
    components of the graph with edges where cosine distance < threshold
    (the same semantic as the AHC stop rule — the raw Laplacian eigengap is
    unreliable for the handful-of-items regimes diarization produces),
    clamped to [min_clusters, max_clusters]. Assignment: rows are embedded
    into the bottom-k eigenvectors of the normalized Laplacian and grouped
    by a deterministic farthest-point-initialized k-means — so boundary
    items are placed by global graph connectivity, not greedy merge order.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)

    normed = embeddings / (
        np.linalg.norm(embeddings, axis=1, keepdims=True) + 1e-9
    )
    sim = normed @ normed.T
    aff = np.clip(sim, 0.0, None)  # nonnegative cosine affinity
    np.fill_diagonal(aff, 0.0)
    deg = aff.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-9))
    lap = np.eye(n) - d_inv_sqrt[:, None] * aff * d_inv_sqrt[None, :]
    _, evecs = np.linalg.eigh(lap)

    if num_clusters is not None:
        k = int(np.clip(num_clusters, 1, n))
    else:
        # connected components over the threshold graph
        adj = (1.0 - sim) < threshold
        np.fill_diagonal(adj, True)
        comp = np.full(n, -1, np.int64)
        n_comp = 0
        for s in range(n):
            if comp[s] >= 0:
                continue
            stack = [s]
            comp[s] = n_comp
            while stack:
                u = stack.pop()
                for v in np.flatnonzero(adj[u]):
                    if comp[v] < 0:
                        comp[v] = n_comp
                        stack.append(v)
            n_comp += 1
        k = int(np.clip(n_comp, min_clusters, max_clusters or n))
    if k <= 1:
        return np.zeros(n, np.int32)

    emb = evecs[:, :k]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)

    # deterministic k-means: farthest-point init, 50 Lloyd iterations
    centers = [int(np.argmax(np.linalg.norm(emb - emb.mean(0), axis=1)))]
    for _ in range(k - 1):
        d2 = np.min(
            ((emb[:, None, :] - emb[None, centers, :]) ** 2).sum(-1), axis=1
        )
        centers.append(int(np.argmax(d2)))
    # cannot-link adjacency (COP-KMeans style constrained assignment:
    # most-confident items assign first; each item takes its nearest
    # center whose cluster holds no cannot-link partner, falling back to
    # nearest when no center is feasible)
    cons: dict = {}
    for a, b in cannot_link or ():
        cons.setdefault(a, []).append(b)
        cons.setdefault(b, []).append(a)

    def assign(d2):
        if not cons:
            return d2.argmin(axis=1)
        lab = np.full(n, -1, np.int64)
        for i in np.argsort(d2.min(axis=1)):
            forbidden = {lab[j] for j in cons.get(int(i), ()) if lab[j] >= 0}
            for c in np.argsort(d2[i]):
                if int(c) not in forbidden:
                    lab[i] = int(c)
                    break
            else:
                lab[i] = int(d2[i].argmin())
        return lab

    cent = emb[centers]
    labels = np.zeros(n, np.int64)
    for _ in range(50):
        d2 = ((emb[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        new_labels = assign(d2)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for c in range(k):
            sel = labels == c
            if sel.any():
                cent[c] = emb[sel].mean(axis=0)
    # compact label ids in first-appearance order
    remap = {}
    out = np.zeros(n, np.int32)
    for i, lab in enumerate(labels):
        out[i] = remap.setdefault(int(lab), len(remap))
    return out
