"""Model families (FourierGrid so far)."""
