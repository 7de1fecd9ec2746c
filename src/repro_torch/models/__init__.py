"""Model code: layers, attention, the dense transformer, weight bridge."""
