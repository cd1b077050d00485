"""Mamba's selective scan: h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t,
y_t = C_t . h_t, for every (batch, channel)."""
