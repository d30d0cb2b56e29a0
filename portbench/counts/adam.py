"""Adam's update of one parameter: the two moments (3 + 4), the bias
corrections (2), the square root, eps, the division, the lr and the
subtraction (5): 14 operations."""


def ops(n_params: int) -> int:
    return 14 * n_params
