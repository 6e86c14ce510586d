"""Host scheduler utilities the port needs (the shuffle that orders nodes)."""
