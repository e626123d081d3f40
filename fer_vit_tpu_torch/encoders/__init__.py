"""pSp GradualStyleEncoder over the IR-SE50 trunk."""
