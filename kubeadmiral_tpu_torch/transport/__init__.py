"""Member-facing transport helpers of the control plane (the
per-member circuit breaker)."""
