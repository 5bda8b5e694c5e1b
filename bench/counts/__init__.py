"""Operation and byte counts from shapes, and the H100's peaks."""
