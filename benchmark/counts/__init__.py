"""Operations and bytes of each stage, and the peaks they are held to."""
