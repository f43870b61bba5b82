"""Framework-free helpers of the port."""
