"""Device engines and their host-side planning."""
