"""Host data: datasets and batch assembly."""
