"""Host data pipeline: image folders, the native decoder, toy datasets."""
