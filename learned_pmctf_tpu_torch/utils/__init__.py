"""Host-side helpers of the bitstream path."""
