"""The Fourier embedding: a multiply, a sine and a cosine for each of
``n_freqs`` frequencies and ``d_in`` coordinates, a sample."""


def ops(n: int, n_freqs: int, d_in: int) -> int:
    return n * 3 * n_freqs * d_in
