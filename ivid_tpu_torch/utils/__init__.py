"""Host-side image utilities."""
