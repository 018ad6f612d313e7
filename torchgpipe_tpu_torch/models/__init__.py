"""Model definitions and the KV-cache generation path."""
