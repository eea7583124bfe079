from .conditioning import TextConditioner
from .prompt import (ComposablePrompt, parse_prompt_attention, parse_prompt_schedule,
                     split_composable)
from .sdxl import SDXLConditioner
from .tokenizer import CLIPTokenizer, HashTokenizer, bytes_to_unicode

__all__ = ["TextConditioner", "SDXLConditioner", "ComposablePrompt", "parse_prompt_attention",
           "parse_prompt_schedule", "split_composable", "CLIPTokenizer", "HashTokenizer",
           "bytes_to_unicode"]
