"""Wire-format helpers of the port (only what the precision module needs)."""
