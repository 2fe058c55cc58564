"""The share of the adjoint's (dK/dv)^T products (its fixed-point trips and
GMRES matvecs) taken through the step's linearization (`BackwardStats`
linear_products), in %.  Nothing where the program does not count them."""


def read(t):
    a = t["adjoint"]
    if not a or "linear_products" not in a:
        return None
    made = a["trips"] + a["gmres_matvecs"]
    if not made:
        return None
    return 100.0 * a["linear_products"] / made
