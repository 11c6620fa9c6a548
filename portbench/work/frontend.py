"""The log-mel of b clips: per kept frame the window, a real FFT (2.5 *
n_fft * log2 n_fft operations, half a complex FFT's), the magnitude (4 per
bin), the filterbank's nonzeros (2 each) and the log (3 per mel). The
waveforms read once, the log-mels written once."""

import math


def work(b, samples, frames, n_fft, n_mels, filterbank_nonzeros):
    n_freq = n_fft // 2 + 1
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 4.0 * n_freq
                 + 2.0 * filterbank_nonzeros + 3.0 * n_mels)
    return b * frames * per_frame, 4.0 * b * (samples + frames * n_mels)
