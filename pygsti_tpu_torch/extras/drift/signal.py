"""Spectral-analysis primitives for drift detection (counterpart of
pygsti_tpu/extras/drift/signal.py).

Power spectra of binary (clickstream) time series, normalized so that for a
constant-probability process each power is ~chi^2_1 distributed -- the basis
for the drift hypothesis tests.  Every function of the JAX package keeps its
numpy form here.  Two batched forms run on `device` for the analyzer:
``dct_power_spectra`` (many streams at once: standardize, one product with
the [T, T] orthonormal DCT-II basis, square) and ``lsp_power_spectra`` (the
Lomb-Scargle periodogram of unequally spaced streams, each with its own
times and frequencies)."""

from __future__ import annotations

import numpy as np
import scipy.stats as stats
import torch
from scipy.fft import dct as _scipy_dct, idct as _scipy_idct

from pygsti_tpu_torch import DTYPE


def standardize_sequence(x, null_hypothesis_probability=None):
    """Standardize a 0/1 sequence: (x - p) / sqrt(p(1-p))."""
    x = np.asarray(x, dtype=float)
    p = null_hypothesis_probability if null_hypothesis_probability is not None \
        else np.mean(x)
    p = min(max(p, 1e-12), 1 - 1e-12)
    return (x - p) / np.sqrt(p * (1 - p))


def dct_power_spectrum(x, null_hypothesis_probability=None):
    """Normalized DCT-II power spectrum of a 0/1 sequence; under the
    constant-p null each mode (except DC) is ~chi^2_1."""
    z = standardize_sequence(x, null_hypothesis_probability)
    modes = _scipy_dct(z, norm='ortho')
    return modes ** 2


def dct_basis_function(omega, T, t):
    """The omega-th orthonormal DCT basis function at time(s) t."""
    if omega == 0:
        return np.ones_like(np.asarray(t, dtype=float)) / np.sqrt(T)
    return np.sqrt(2.0 / T) * np.cos(np.pi * omega * (np.asarray(t) + 0.5) / T)


def lsp_power_spectrum(x, timestamps, frequencies):
    """Lomb-Scargle periodogram for unequally-spaced data."""
    from scipy.signal import lombscargle
    z = standardize_sequence(x)
    ang = 2 * np.pi * np.asarray(frequencies)
    ang = np.where(ang == 0, 1e-12, ang)
    return lombscargle(np.asarray(timestamps, dtype=float), z, ang, normalize=False)


def dct_basis(T, device="cuda"):
    """The orthonormal DCT-II basis [T, T] on `device`: row k is
    sqrt(2/T) cos(pi k (n + 1/2) / T) (k = 0: 1/sqrt(T)).  The angle's
    multiple of pi / (2T) is reduced mod 4T in integers first, so the
    cosine's argument stays below 2 pi whatever T."""
    k = torch.arange(T, dtype=torch.int64, device=device)
    m = (k[:, None] * (2 * k[None, :] + 1)) % (4 * T)
    basis = torch.cos(m.to(DTYPE) * (np.pi / (2 * T))) * np.sqrt(2.0 / T)
    basis[0] = 1.0 / np.sqrt(T)
    return basis


def standardize_sequences(X):
    """standardize_sequence over the last axis of a tensor X [..., T]."""
    p = torch.clamp(X.mean(dim=-1, keepdim=True), 1e-12, 1 - 1e-12)
    return (X - p) / torch.sqrt(p * (1 - p))


def dct_power_spectra(X, device="cuda"):
    """dct_power_spectrum of every stream of X [..., T] (numpy or tensor)
    at once on `device`: standardize each, take the orthonormal DCT-II as
    one product with the [T, T] basis, square.  Returns a tensor [..., T]."""
    X = torch.as_tensor(X, dtype=DTYPE, device=device)
    return (standardize_sequences(X) @ dct_basis(X.shape[-1], X.device).T) ** 2


def lsp_power_spectra(X, times, frequencies, device="cuda", chunk_bytes=1 << 30):
    """lsp_power_spectrum of every stream of X [N, T] at its own times
    [N, T] and frequencies [N, F], on `device`: the standardized stream's
    Lomb-Scargle periodogram with scipy's 'power' normalization (no
    floating mean, equal weights), a zero angular frequency moved to 1e-12
    as in the numpy form.  The [rows, F, T] intermediates are taken in
    chunks of rows of about `chunk_bytes`.  Returns a tensor [N, F]."""
    X = torch.as_tensor(X, dtype=DTYPE, device=device)
    times = torch.as_tensor(times, dtype=DTYPE, device=X.device)
    ang = 2 * np.pi * torch.as_tensor(frequencies, dtype=DTYPE, device=X.device)
    ang = torch.where(ang == 0, 1e-12, ang)
    N, T = X.shape
    z = standardize_sequences(X)
    eps = float(np.finfo(np.float64).epsneg)
    rows = max(1, chunk_bytes // max(8 * ang.shape[1] * T * 4, 1))
    out = []
    for s in range(0, N, rows):
        wt = ang[s:s + rows, :, None] * times[s:s + rows, None, :]          # [n, F, T]
        c, sn = torch.cos(wt), torch.sin(wt)
        CC = (c * c).mean(-1)
        CS = (c * sn).mean(-1)
        tau = 0.5 * torch.atan2(2 * CS, CC - (1 - CC))
        wt = wt - tau[..., None]
        c, sn = torch.cos(wt), torch.sin(wt)
        y = z[s:s + rows, None, :]
        YC, YS = (y * c).mean(-1), (y * sn).mean(-1)
        CC = (c * c).mean(-1)
        SS = torch.clamp(1 - CC, min=eps)
        CC = torch.clamp(CC, min=eps)
        out.append(2 * (YC * YC / CC + YS * YS / SS) * (T / 4.0))
    return torch.cat(out)


def power_significance_threshold(significance, numtests, dof=1):
    """Bonferroni-corrected chi^2 power threshold for `numtests` modes.

    Powers averaged over `dof` independent chi^2_1 spectra are distributed
    as chi^2_dof / dof under the null, so the threshold is normalized by
    `dof` (reference: signal.py:398 power_significance_threshold)."""
    return stats.chi2.isf(significance / numtests, dof) / dof


def power_significance_quasithreshold(significance, numstats, dof,
                                      procedure='Benjamini-Hochberg'):
    """The Benjamini-Hochberg quasi-threshold: sorted powers are compared
    to this ascending sequence; everything above the first exceedance is
    significant (reference: signal.py:434)."""
    if procedure != 'Benjamini-Hochberg':
        raise ValueError(
            "Can only obtain a quasithreshold for the Benjamini-Hochberg "
            "procedure!")
    return np.array([stats.chi2.isf((numstats - i) * significance / numstats,
                                    dof) / dof for i in range(numstats)])


def power_to_pvalue(power, dof):
    """p-value of a power that is chi^2_dof/dof under the null
    (reference: signal.py:410)."""
    return 1 - stats.chi2.cdf(dof * power, dof)


def maxpower_pvalue(maxpower, numpowers, dof):
    """Approximate p-value of the largest of `numpowers` iid chi^2_dof/dof
    powers (reference: signal.py:420)."""
    return 1 - stats.chi2.cdf(maxpower * dof, dof) ** (numpowers - 1)


def frequencies_from_timestep(timestep, T):
    """DCT mode frequencies (Hz) for sample interval `timestep` and length T."""
    return np.arange(T) / (2 * timestep * T)


def dct_amplitudes_at_frequencies(freq_indices, bits):
    """Amplitudes of a 0/1 sequence at the given DCT mode indices, in the
    CosineProbTrajectory basis convention (basis functions 1 and
    sqrt(2)cos(pi k (t+1/2)/T); reference: signal.py
    amplitudes_at_frequencies).  amp_k = DCT-II-ortho coefficient / sqrt(T),
    so sum_k amp_k * basis_k(t) reconstructs the sequence."""
    bits = np.asarray(bits, dtype=float)
    T = len(bits)
    modes = _scipy_dct(bits, norm='ortho')
    return [float(modes[k]) / np.sqrt(T) for k in freq_indices]


def sparse_signal_from_modes(mode_indices, mode_amplitudes, T, mean=0.5):
    """Reconstruct a probability trajectory from a few DCT modes."""
    t = np.arange(T)
    out = np.full(T, float(mean))
    for k, a in zip(mode_indices, mode_amplitudes):
        out = out + a * dct_basis_function(k, T, t)
    return out


# =============================================================================
# The user-facing surface of the JAX package's module (the functions above
# are the analyzer's compact forms), on numpy and scipy.  All "standardized" transforms rescale clickstream data x as
#   y = (x - counts*p0) / sqrt(counts*p0*(1-p0))
# so that under the constant-p0 null each spectral power is ~chi^2_1.
# =============================================================================

def standardizer(x, null_hypothesis=None, counts=1):
    """Standardize clickstream data against a null probability trajectory
    (reference: signal.py:120).  Returns None when the null is degenerate
    (mean of x is 0 or counts)."""
    x = np.asarray(x, dtype=float)
    if null_hypothesis is None:
        null_hypothesis = np.mean(x) / counts
        if null_hypothesis <= 0 or null_hypothesis >= 1:
            return None
    null_hypothesis = np.asarray(null_hypothesis, dtype=float)
    return (x - counts * null_hypothesis) / np.sqrt(
        counts * null_hypothesis * (1 - null_hypothesis))


def unstandardizer(z, null_hypothesis, counts=1):
    """Invert `standardizer` (reference: signal.py:143)."""
    null_hypothesis = np.asarray(null_hypothesis, dtype=float)
    return np.asarray(z) * np.sqrt(
        counts * null_hypothesis * (1 - null_hypothesis)) \
        + counts * null_hypothesis


def _degenerate_modes(n):
    out = np.ones(n)
    out[0] = 0.0
    return out


def dct_modes(x, null_hypothesis=None, counts=1):
    """Orthonormal type-II DCT of the standardized data (reference:
    signal.py:150 `dct`; renamed here to avoid shadowing scipy's dct --
    the reference name is exported as `dct` from this module too)."""
    z = standardizer(x, null_hypothesis, counts)
    if z is None:
        return _degenerate_modes(len(x))
    return _scipy_dct(z, norm='ortho')


def idct_modes(modes, null_hypothesis, counts=1):
    """Invert `dct_modes` (reference: signal.py:192 `idct`)."""
    return unstandardizer(
        _scipy_idct(np.asarray(modes, dtype=float), norm='ortho'),
        null_hypothesis, counts)


def dft(x, null_hypothesis=None, counts=1):
    """Unitary DFT of the standardized data (reference: signal.py:221)."""
    z = standardizer(x, null_hypothesis, counts)
    if z is None:
        return _degenerate_modes(len(x))
    return np.fft.fft(z) / np.sqrt(len(np.asarray(x)))


def idft(modes, null_hypothesis, counts=1):
    """Invert `dft` (reference: signal.py:264)."""
    modes = np.asarray(modes)
    z = np.sqrt(len(modes)) * np.fft.ifft(modes)
    return unstandardizer(z.real, null_hypothesis, counts)


def lsp(x, times, frequencies='auto', null_hypothesis=None, counts=1):
    """Floating-mean (generalized) Lomb-Scargle periodogram of the
    standardized data with PSD normalization, for unequally-spaced
    timestamps (reference: signal.py:293, which delegates to astropy;
    implemented natively here via the Zechmeister-Kuerster closed form).
    Returns (frequencies, powers)."""
    x = np.asarray(x, dtype=float)
    times = np.asarray(times, dtype=float)
    numtimes = len(x)
    if isinstance(frequencies, str):
        freq = frequencies_from_timestep(
            (np.max(times) - np.min(times)) / numtimes, numtimes)
    else:
        freq = np.asarray(frequencies, dtype=float)

    z = standardizer(x, null_hypothesis, counts)
    if z is None:
        return freq, _degenerate_modes(len(freq))

    lspfreq = freq[1:] if freq[0] == 0. else freq
    power = np.empty(len(lspfreq))
    for i, f in enumerate(lspfreq):
        w = 2 * np.pi * f * times
        c, s = np.cos(w), np.sin(w)
        # floating-mean model z ~ a*cos + b*sin + off: solve 3x3 normal eqs
        M = np.array([[c @ c, c @ s, c.sum()],
                      [c @ s, s @ s, s.sum()],
                      [c.sum(), s.sum(), float(numtimes)]])
        v = np.array([c @ z, s @ z, z.sum()])
        try:
            a, b, off = np.linalg.solve(M, v)
        except np.linalg.LinAlgError:
            a, b, off = np.linalg.lstsq(M, v, rcond=None)[0]
        model = a * c + b * s + off
        # PSD normalization: 0.5 * chi2 reduction of the mean-only model
        zc = z - z.mean()
        power[i] = 0.5 * (zc @ zc - (z - model) @ (z - model))
    if freq[0] == 0.:
        power = np.concatenate([[0.0], power])
    return freq, power


def spectrum(x, times=None, null_hypothesis=None, counts=1,
             frequencies='auto', transform='dct', returnfrequencies=True):
    """Power spectrum of clickstream data (reference: signal.py:26).
    Returns (freqs, modes, powers) -- or (modes, powers) when
    returnfrequencies is False.  modes is None for the 'lsp' transform;
    freqs is None when no timestamps are available for 'dct'/'dft'."""
    if transform in ('dct', 'dft'):
        if transform == 'dct':
            modes = dct_modes(x, null_hypothesis, counts)
            powers = modes ** 2
        else:
            modes = dft(x, null_hypothesis, counts)
            powers = np.abs(modes) ** 2
        if returnfrequencies:
            if isinstance(frequencies, str):
                freqs = None if times is None \
                    else fourier_frequencies_from_times(times)
            else:
                freqs = frequencies
            return freqs, modes, powers
        return modes, powers
    elif transform == 'lsp':
        freqs, powers = lsp(x, times, frequencies, null_hypothesis, counts)
        if returnfrequencies:
            return freqs, None, powers
        return None, powers
    raise ValueError("Input `transform` type invalid!")


def bartlett_spectrum(x, numspectra, counts=1, null_hypothesis=None,
                      transform='dct'):
    """Bartlett (chunk-averaged) power spectrum (reference: signal.py:338)."""
    x = np.asarray(x, dtype=float)
    length = int(np.floor(len(x) / numspectra))
    if null_hypothesis is None:
        null_hypothesis = np.mean(x) * np.ones(len(x)) / counts
    spectra = np.zeros((numspectra, length))
    for i in range(numspectra):
        _, powers = spectrum(x[i * length:(i + 1) * length], counts=counts,
                             null_hypothesis=null_hypothesis[
                                 i * length:(i + 1) * length],
                             transform=transform, returnfrequencies=False)
        spectra[i, :] = powers
    return np.mean(spectra, axis=0)


def dct_basisfunction(omega, times, starttime, timedif):
    """The omega-th (unnormalized) DCT basis function at `times`
    (reference: signal.py:389)."""
    times = np.asarray(times, dtype=float)
    return np.cos(omega * np.pi * (times - starttime + 0.5) / timedif)


def fourier_frequencies_from_times(times):
    """Fourier frequencies of (approximately) equally-spaced timestamps
    (reference: signal.py:542)."""
    times = np.asarray(times, dtype=float)
    return frequencies_from_timestep(float(np.mean(np.diff(times))),
                                     len(times))


def compute_auto_frequencies(ds, transform='dct'):
    """The default per-circuit frequency grids for a DataSet's time-series
    data (reference: signal.py:449).  Returns (frequencies_list,
    pointers)."""
    from pygsti_tpu_torch.data.dataset import DataSet
    from pygsti_tpu_torch.data.multidataset import MultiDataSet
    if transform not in ('dct', 'dft', 'lsp'):
        raise ValueError("The type of transform is invalid!")
    if isinstance(ds, MultiDataSet):
        inner = ds[list(ds.keys())[0]]
    elif isinstance(ds, DataSet):
        inner = ds
    else:
        raise ValueError("Input data must be a DataSet or MultiDataSet!")
    # the JAX package reads DataSet.meantimestep and row.number_of_times,
    # which neither package defines: here the mean step between a row's
    # distinct times, averaged over the rows, and the first row's count of
    # distinct times (ROADMAP.md section 3)
    steps = [np.mean(np.diff(np.unique(inner[c].time))) for c in inner.keys()
             if inner[c].time is not None and len(np.unique(inner[c].time)) > 1]
    if not steps:
        raise ValueError("compute_auto_frequencies needs time-series data")
    numtimes = len(np.unique(inner[list(inner.keys())[0]].time))
    return [frequencies_from_timestep(float(np.mean(steps)), numtimes)], {}


def amplitudes_at_frequencies(freq_indices, timeseries, times=None,
                              transform='dct'):
    """Per-outcome amplitudes of {outcome: clickstream} data at the given
    DCT frequency indices, in the probability-trajectory basis convention
    (reference: signal.py:567)."""
    if transform != 'dct':
        raise NotImplementedError(
            "This function only currently works for the DCT!")
    amplitudes = {}
    for o, series in timeseries.items():
        series = np.asarray(series, dtype=float)
        temp = _scipy_dct(series, norm='ortho')[np.asarray(freq_indices)] \
            / np.sqrt(len(series) / 2)
        if 0 in list(freq_indices):
            temp[list(freq_indices).index(0)] /= np.sqrt(2)
        amplitudes[o] = list(temp)
    return amplitudes


def sparsity(p):
    """Hoyer sparsity index of `p` (reference: signal.py:587)."""
    p = np.asarray(p, dtype=float)
    n = len(p)
    return (np.sqrt(n) - np.linalg.norm(p, 1) / np.linalg.norm(p, 2)) \
        / (np.sqrt(n) - 1)


def logistic_transform(x, mean):
    """Squash `x` around `mean` into [0,1] with a logistic of width
    nu = min(mean, 1-mean) (reference: signal.py:643)."""
    nu = min(1 - mean, mean)
    return mean - nu + (2 * nu) / (1 + np.exp(-2 * (np.asarray(x) - mean) / nu))


def renormalizer(p, method='logistic'):
    """Map an arbitrary vector into [0,1] ('sharp' clip or 'logistic'
    squash; reference: signal.py:600)."""
    p = np.asarray(p, dtype=float)
    if method == 'logistic':
        return logistic_transform(p, np.mean(p))
    elif method == 'sharp':
        return np.clip(p, 0.0, 1.0)
    raise ValueError("method should be 'logistic' or 'sharp'")


def lowpass_filter(data, max_freq=None):
    """DCT low-pass filter keeping the lowest `max_freq` modes
    (reference: signal.py:656)."""
    data = np.asarray(data, dtype=float)
    n = len(data)
    if max_freq is None:
        max_freq = min(int(np.ceil(n / 10)), 50)
    modes = _scipy_dct(data, norm='ortho')
    if max_freq < n - 1:
        modes[max_freq + 1:] = 0.0
    return _scipy_idct(modes, norm='ortho')


def moving_average(sequence, width=100):
    """Edge-corrected moving average (reference: signal.py:690)."""
    sequence = np.asarray(sequence, dtype=float)
    kernel = np.ones(int(width)) / float(width)
    base = np.convolve(np.ones(len(sequence)), kernel, mode='same')
    return np.convolve(sequence, kernel, mode='same') / base


def generate_flat_signal(power, nummodes, n, candidatefreqs=None, base=0.5,
                         method='sharp'):
    """A probability trajectory with `power` spread equally over `nummodes`
    randomly-chosen DCT modes with random phases (reference:
    signal.py:701)."""
    amppermode = np.sqrt(power / nummodes)
    if candidatefreqs is None:
        candidatefreqs = np.arange(1, n)
    freqs = np.random.choice(candidatefreqs, size=nummodes, replace=False)
    modes = np.zeros(n)
    phases = np.random.binomial(1, 0.5, size=nummodes)
    modes[freqs] = amppermode * (-1.0) ** phases
    p = idct_modes(modes, base * np.ones(n))
    if method is not None:
        p = renormalizer(p, method=method)
    return p


def generate_gaussian_signal(power, center, spread, n, base=0.5,
                             method='sharp'):
    """A probability trajectory whose spectral power is an approximately
    Gaussian bump centered at mode `center` (reference: signal.py:764)."""
    modes = np.zeros(n)
    modes[1:] = np.exp(-(np.arange(1, n) - center) ** 2 / (2 * spread ** 2))
    modes = modes * (-1.0) ** np.random.binomial(1, 0.5, size=n)
    modes = np.sqrt(power) * modes / np.sqrt(np.sum(modes ** 2))
    p = idct_modes(modes, base * np.ones(n))
    if method is not None:
        p = renormalizer(p, method=method)
    return p


# reference module-level names for the standardized transforms
# (`dct`/`idct` in the reference shadow scipy's; here the implementations
# live in dct_modes/idct_modes and these aliases export the reference names)
dct = dct_modes
idct = idct_modes
