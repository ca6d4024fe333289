"""Training numerics and trainers: fixed point, the LUT sigmoid, LIN, LOG."""
