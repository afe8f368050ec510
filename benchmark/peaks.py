"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit; a card set lower runs slower under load, so every
share of a peak is stated with the card's limit beside it)."""

HBM_BYTES_PER_S = 3.35e12
