"""Host-side image preprocessing."""
