"""Data-side pieces of the serving path: normalization constants and the
on-device dequantize of the uint8 wire format."""
