"""PLDA (probabilistic LDA) scoring for speaker embeddings.

Counterpart of ``whisperx_tpu/diarize/plda.py``, kept as its own copy (host
numpy, the same arithmetic and file format: a PLDA saved by either package
loads in the other).

The two-covariance model used across speaker-verification stacks
(Kaldi's plda, pyannote's clustering options): an embedding is
``x = mu + v + e`` with a speaker latent ``v ~ N(0, Sigma_b)`` and a
channel residual ``e ~ N(0, Sigma_w)``. After simultaneous
diagonalization (whiten the within-class covariance, then rotate to
diagonalize the between-class covariance) every dimension is an
independent 1-D problem: within-variance 1, between-variance ``psi_d``.

The pairwise same/different-speaker log-likelihood ratio then has a
closed form that separates into per-item and cross terms, so the full
N x N score matrix is one rank-D GEMM (`llr_matrix`) — no per-pair loop.

This replaces cosine scoring inside the diarization clustering
(``DiarizationPipeline(clustering="plda")``): cosine treats every
direction of embedding space as equally speaker-discriminative; PLDA
learns which directions carry voice identity vs channel noise. The
reference delegates this choice to pyannote's internals
(reference whisperx/diarize.py:11-83); here it is a first-class,
trainable component.

Parameters come from a converted checkpoint (``PLDA.load`` /
``WHISPERX_TPU_PLDA_CKPT``) or from ``PLDA.fit`` on any labeled
embedding set — including self-training on the utterance being
diarized (pseudo-labels from a conservative cosine pre-clustering).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class PLDA:
    """Two-covariance PLDA in diagonalized form.

    Attributes
    ----------
    mean : [D] training-set embedding mean
    transform : [D, D] simultaneous-diagonalization transform ``T``
        (``T Sigma_w T^t = I``, ``T Sigma_b T^t = diag(psi)``)
    psi : [D] between-speaker variances in the transformed space
    length_norm : embeddings are projected to ``sqrt(D)``-radius sphere
        before scoring (standard practice; stabilizes Gaussian modeling)
    """

    def __init__(self, mean: np.ndarray, transform: np.ndarray,
                 psi: np.ndarray, length_norm: bool = True):
        self.mean = np.asarray(mean, np.float64)
        self.transform = np.asarray(transform, np.float64)
        self.psi = np.asarray(psi, np.float64)
        self.length_norm = bool(length_norm)

    # -- estimation --------------------------------------------------------

    @classmethod
    def fit(cls, embeddings: np.ndarray, labels: np.ndarray,
            length_norm: bool = True, floor: float = 1e-4) -> "PLDA":
        """Closed-form two-covariance estimation from labeled embeddings.

        Within-class covariance from per-class centered scatter; raw
        between-class covariance from class-mean scatter, debiased by the
        sampling noise of those means (each class mean carries
        ``Sigma_w / n_c`` of within-class noise — without the correction
        psi is systematically inflated for small classes). Classes need
        >= 2 members to inform the within-class scatter; at least two
        such classes are required.
        """
        x = np.asarray(embeddings, np.float64)
        labels = np.asarray(labels)
        if x.ndim != 2:
            raise ValueError(f"embeddings must be [N, D], got {x.shape}")
        if length_norm:
            x = _sphere(x)
        classes = [np.flatnonzero(labels == c) for c in np.unique(labels)]
        multi = [idx for idx in classes if len(idx) >= 2]
        if len(multi) < 2:
            raise ValueError(
                "PLDA.fit needs >= 2 classes with >= 2 embeddings each "
                f"(got {len(multi)} of {len(classes)} classes)"
            )
        d = x.shape[1]
        mean = x.mean(axis=0)
        n_within = sum(len(idx) - 1 for idx in multi)

        # Rank guard: with fewer within-class degrees of freedom than
        # dimensions (the self-training regime: tens of windows, a
        # 100+-dim embedding) the within scatter is singular, and
        # flooring its null-space eigenvalues would whiten unmeasurable
        # directions by 1/sqrt(floor) — noise there would then dominate
        # the LLR. Project onto the top-r principal components first.
        r = int(min(d, n_within, len(x) - 1))
        x_c = x - mean
        if r < d:
            _, _, vt = np.linalg.svd(x_c, full_matrices=False)
            basis = vt[:r]  # [r, d]
            x_p = x_c @ basis.T
        else:
            basis = None
            x_p = x_c

        sw = np.zeros((r, r))
        for idx in multi:
            xc = x_p[idx] - x_p[idx].mean(axis=0)
            sw += xc.T @ xc
        sw /= max(n_within, 1)

        n_total = sum(len(idx) for idx in classes)
        sb = np.zeros((r, r))
        for idx in classes:
            mc = x_p[idx].mean(axis=0) - x_p.mean(axis=0)
            sb += len(idx) * np.outer(mc, mc)
        sb /= n_total

        # whiten Sigma_w: W1 Sigma_w W1^t = I
        ew, uw = np.linalg.eigh(sw)
        ew = np.maximum(ew, floor)
        w1 = (uw / np.sqrt(ew)).T
        # diagonalize the whitened Sigma_b, descending
        sb_t = w1 @ sb @ w1.T
        eb, ub = np.linalg.eigh(sb_t)
        order = np.argsort(eb)[::-1]
        eb, ub = eb[order], ub[:, order]
        # debias: class means carry Sigma_w/n_c of within-class noise,
        # which is identity/n_c in the whitened space
        noise = float(np.mean([1.0 / len(idx) for idx in classes]))
        psi = np.maximum(eb - noise, floor)
        transform = ub.T @ w1  # [r, r]
        if basis is not None:
            transform = transform @ basis  # [r, d]
        return cls(mean, transform, psi, length_norm=length_norm)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(
            path, mean=self.mean, transform=self.transform, psi=self.psi,
            length_norm=np.array(self.length_norm),
        )

    @classmethod
    def load(cls, path: str) -> "PLDA":
        # np.savez appends ".npz" when the suffix is missing — accept the
        # same path back (save("plda") → load("plda") must work)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path)
        return cls(
            z["mean"], z["transform"], z["psi"],
            length_norm=bool(z["length_norm"]) if "length_norm" in z else True,
        )

    # -- scoring -------------------------------------------------------------

    def transform_embeddings(self, x: np.ndarray) -> np.ndarray:
        """Raw embeddings → the diagonalized latent space ``u``."""
        x = np.asarray(x, np.float64)
        if self.length_norm:
            x = _sphere(x)
        return (x - self.mean) @ self.transform.T

    def llr_matrix(self, x: np.ndarray) -> np.ndarray:
        """Pairwise same-vs-different-speaker log-likelihood ratios [N, N].

        Per dimension (within-var 1, between-var psi), the same-speaker
        joint covariance of a pair is [[1+psi, psi], [psi, 1+psi]] and the
        different-speaker one is diag(1+psi); the LLR separates as
        ``C + a·u_i^2 + a·u_j^2 + b·u_i u_j`` summed over dims — so the
        whole matrix is one GEMM plus broadcast adds. LLR > 0 means
        same-speaker is the likelier hypothesis.
        """
        u = self.transform_embeddings(x)
        psi = self.psi
        det_s = 1.0 + 2.0 * psi           # det of same-speaker 2x2 (unit diag)
        var_d = 1.0 + psi                 # different-speaker marginal var
        const = float(np.sum(np.log(var_d) - 0.5 * np.log(det_s)))
        alpha = 0.5 * (1.0 / var_d - var_d / det_s)   # per-item quadratic
        beta = psi / det_s                            # cross term (>= 0)
        s = (u * u) @ alpha               # [N]
        cross = (u * beta) @ u.T          # [N, N]
        return const + s[:, None] + s[None, :] + cross

    def llr(self, a: np.ndarray, b: np.ndarray) -> float:
        """Scalar LLR for one pair (verification-style)."""
        return float(self.llr_matrix(np.stack([a, b]))[0, 1])


def _sphere(x: np.ndarray) -> np.ndarray:
    """Length-norm to the sqrt(D) sphere (matches Kaldi's convention so
    per-dim variances stay O(1) rather than O(1/D))."""
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x * (np.sqrt(x.shape[-1]) / np.maximum(norms, 1e-9))


def plda_distances(embeddings: np.ndarray, plda: PLDA) -> np.ndarray:
    """Negated LLR as a clustering distance matrix: same-speaker pairs
    sit below 0, different-speaker above — AHC with ``threshold=0.0``
    implements the Bayes same/different decision at every merge."""
    return -plda.llr_matrix(embeddings)


def self_trained_plda(
    embeddings: np.ndarray,
    *,
    pretrain_threshold: float = 0.15,
    length_norm: bool = True,
) -> Optional[PLDA]:
    """Fit PLDA on the utterance being diarized, without labels.

    Pseudo-labels come from a deliberately conservative cosine AHC
    (threshold 0.15 merges only near-duplicates), yielding many small,
    high-purity clusters: enough to estimate which embedding directions
    vary within a voice vs across voices. Returns None when the utterance
    can't support estimation (too few multi-member pseudo-classes) — the
    caller should fall back to cosine scoring.
    """
    from whisperx_tpu_torch.diarize.clustering import agglomerative_cluster

    if len(embeddings) < 8:
        return None
    pseudo = agglomerative_cluster(
        np.asarray(embeddings), threshold=pretrain_threshold
    )
    try:
        return PLDA.fit(embeddings, pseudo, length_norm=length_norm)
    except (ValueError, np.linalg.LinAlgError):
        return None


def load_plda(path: Optional[str] = None) -> Optional[PLDA]:
    """PLDA params from an npz checkpoint (arg, or WHISPERX_TPU_PLDA_CKPT)."""
    path = path or os.environ.get("WHISPERX_TPU_PLDA_CKPT")
    if path and (os.path.exists(path) or os.path.exists(path + ".npz")):
        return PLDA.load(path)
    return None
