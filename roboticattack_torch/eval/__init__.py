"""Policy wrapper (VLAPolicy, load_policy) and eval-time processing."""
