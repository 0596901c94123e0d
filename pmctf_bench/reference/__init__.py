"""The plain reference of pMCTF-L's estimate path (imports nothing of the port)."""
