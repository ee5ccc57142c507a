"""End-to-end audio source separation with NMFD on the card: waveform in,
stems out.

The PyTorch/CUDA port's counterpart of ``examples/audio_separation.py``.
The reference's real-audio demo (examples/librosa_example.py) loads a
recording with librosa, STFTs it, and fits a rank-3 T=400 NMFD to the
magnitude spectrogram.  This example closes the same loop with scipy: it
*synthesizes* a three-source percussion loop (kick / snare / hi-hat, each
with its own onset pattern), mixes it, and then

1. STFTs the mixture on the host (``scipy.signal.stft``, Hann window),
2. moves the magnitude spectrogram to the model's device and fits an NMFD
   to it (one convolutive template per percussive event class, the
   reference's model choice; on the card its updates run the port's
   ``hgrad``/``wgrad`` kernels),
3. rebuilds each component's magnitude ``W_r * H_r`` on the device, brings
   it back, converts it to a Wiener soft mask and applies the mask to the
   complex mixture STFT, and
4. inverts each masked STFT (``scipy.signal.istft``) back to a waveform,

then scores the separated stems against the true sources with scale-
invariant SNR.  The templates and activations start from ``|N(0, 1)|``
draws of an explicit numpy seed, so the CPU and the card start from the
same factors; nothing about the synthesis leaks into the factorization.

Run:  python examples/torch_port/audio_separation.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch
from scipy import signal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from pytorch_nmf_tpu_torch.nmf import NMFD  # noqa: E402


def synth_sources(sr=8000, duration=4.0, seed=0):
    """Three percussive sources with interleaved 8th-note patterns."""
    rng = np.random.RandomState(seed)
    n = int(sr * duration)
    eighth = int(sr * 0.25)

    def place(pattern, hit):
        x = np.zeros(n, "f")
        for k, on in enumerate(pattern * (n // (eighth * len(pattern)) + 1)):
            start = k * eighth
            if not on or start >= n:
                continue
            seg = hit[: n - start]
            x[start:start + len(seg)] += seg
        return x

    # kick: decaying sine sweep 120 -> 50 Hz
    dur = int(sr * 0.15)
    td = np.arange(dur) / sr
    freq = 120 * np.exp(-td * 12) + 50
    kick = np.sin(2 * np.pi * np.cumsum(freq) / sr) * np.exp(-td * 18)
    # snare: 200 Hz body + band-limited noise burst
    dur_s = int(sr * 0.12)
    ts = np.arange(dur_s) / sr
    body = np.sin(2 * np.pi * 190 * ts) * np.exp(-ts * 25)
    noise = rng.randn(dur_s)
    lo, hi = min(1000, 0.2 * sr), min(3000, 0.42 * sr)
    b, a = signal.butter(2, [lo / (sr / 2), hi / (sr / 2)], "band")
    snare = (0.5 * body + 0.8 * signal.lfilter(b, a, noise)
             * np.exp(-ts * 30))
    # hi-hat: short high-passed noise tick
    dur_h = int(sr * 0.05)
    th = np.arange(dur_h) / sr
    bh, ah = signal.butter(2, min(3200, 0.44 * sr) / (sr / 2), "high")
    hat = signal.lfilter(bh, ah, rng.randn(dur_h)) * np.exp(-th * 60) * 0.6

    sources = np.stack([
        place([1, 0, 0, 0, 1, 0, 1, 0], kick.astype("f")),
        place([0, 0, 1, 0, 0, 0, 1, 0], snare.astype("f")),
        place([1, 1, 1, 1, 1, 1, 1, 1], hat.astype("f")),
    ])
    return sources, sr


def si_snr(est, ref):
    """Scale-invariant SNR in dB."""
    ref = ref - ref.mean()
    est = est - est.mean()
    proj = (est @ ref) / ((ref @ ref) + 1e-12) * ref
    noise = est - proj
    return 10 * np.log10(
        (proj @ proj + 1e-12) / (noise @ noise + 1e-12)
    )


def spectrogram(mix, sr, nperseg=256, noverlap=None):
    """``(Z, S)``: the complex STFT of ``mix`` (host) and its magnitude as a
    ``(1, F, L)`` float32 array, the NMFD target."""
    noverlap = nperseg // 2 if noverlap is None else noverlap
    _, _, Z = signal.stft(mix, sr, nperseg=nperseg, noverlap=noverlap)
    return Z, np.abs(Z).astype("f")[None]


def init_factors(S_shape, rank, T):
    """``(W0, H0)``: ``|N(0, 1)|`` templates ``(F, R, T)`` and activations
    ``(1, R, L - T + 1)`` from numpy seed 0."""
    _, F, L = S_shape
    rs = np.random.RandomState(0)
    W0 = np.abs(rs.randn(F, rank, T)).astype("f")
    H0 = np.abs(rs.randn(1, rank, L - T + 1)).astype("f")
    return W0, H0


def wiener_stems(comps, Z, sr, nperseg, noverlap, n):
    """Mask the complex STFT ``Z`` by each component's share of the power
    and invert: ``(R, n)`` waveforms."""
    power = comps ** 2
    denom = power.sum(0, keepdims=True) + 1e-12
    stems = []
    for r in range(len(comps)):
        masked = (power[r] / denom[0]) * Z  # Wiener mask on the complex STFT
        _, x = signal.istft(masked, sr, nperseg=nperseg, noverlap=noverlap)
        stems.append(x[:n].astype("f"))
    return np.stack(stems)


def separate(mix, sr, rank=3, T=8, nperseg=256, max_iter=200, beta=1,
             verbose=False, device="cuda", W0=None, H0=None, noverlap=None,
             tol=1e-4):
    """Fit an NMFD on ``device`` to the mixture spectrogram and return
    ``(stems, comps, n_iter)``: per-component waveforms via Wiener-masked
    ISTFT, the components' magnitudes ``(R, F, L)`` and the iterations run.
    ``W0``/``H0`` (numpy) override the ``|N(0, 1)|`` inits of seed 0; ``tol``
    is the fit's stopping tolerance (``-inf`` runs ``max_iter``)."""
    noverlap = nperseg // 2 if noverlap is None else noverlap
    Z, S = spectrogram(mix, sr, nperseg, noverlap)
    if W0 is None or H0 is None:
        W0, H0 = init_factors(S.shape, rank, T)

    net = NMFD(W=torch.from_numpy(W0), H=torch.from_numpy(H0), device=device)
    V = torch.from_numpy(S).to(net.W.device)
    n_iter = net.fit(V, beta=beta, tol=tol, max_iter=max_iter,
                     verbose=verbose)

    with torch.no_grad():
        W, H = net.W.detach(), net.H.detach()  # (F, R, T), (1, R, L-T+1)
        comps = np.stack([
            NMFD.reconstruct(H[:, r:r + 1], W[:, r:r + 1])[0].cpu().numpy()
            for r in range(W.shape[1])
        ])  # (R, F, L)
    return wiener_stems(comps, Z, sr, nperseg, noverlap, len(mix)), comps, \
        n_iter


def score(stems, sources, mix, verbose=True):
    """Assign each stem to its best-matching source (blind component order,
    greedy on SI-SNR) and return the mean SI-SNR gain over the mixture."""
    n = min(stems.shape[1], sources.shape[1])
    gains = np.array([
        [si_snr(stems[r, :n], sources[s, :n]) for s in range(len(sources))]
        for r in range(len(stems))
    ])
    assign = {}
    for _ in range(min(len(stems), len(sources))):
        r, s = np.unravel_index(np.argmax(gains), gains.shape)
        assign[s] = (r, gains[r, s])
        gains[r, :] = -np.inf
        gains[:, s] = -np.inf

    names = ["kick", "snare", "hi-hat"]
    improvements = []
    for s, (r, snr) in sorted(assign.items()):
        base = si_snr(mix[:n], sources[s, :n])
        improvements.append(snr - base)
        if verbose:
            print(f"{names[s]:7s}: component {r}  SI-SNR {snr:6.2f} dB "
                  f"(mixture baseline {base:6.2f} dB, +{snr - base:.2f})")
    return float(np.mean(improvements))


def main(sr=8000, duration=4.0, rank=3, T=8, nperseg=256, max_iter=200,
         verbose=True, device="cuda"):
    sources, sr = synth_sources(sr=sr, duration=duration)
    mix = sources.sum(0)
    if verbose:
        print(f"mixture: {len(mix)} samples @ {sr} Hz, {len(sources)} "
              f"sources; fitting on {device}")

    stems, _, _ = separate(
        mix, sr, rank=rank, T=T, nperseg=nperseg, max_iter=max_iter,
        verbose=verbose, device=device,
    )

    mean_gain = score(stems, sources, mix, verbose=verbose)
    if verbose:
        print(f"mean SI-SNR improvement over the raw mixture: "
              f"{mean_gain:.2f} dB")
    return mean_gain


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    main(device=ap.parse_args().device)
