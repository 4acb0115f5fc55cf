"""Prompt for the llm-consensus string mode.

Parity target: ``system_prompt_string_consensus_llm`` at
`k_llms/utils/consensus_utils.py:989-1024` (including the
"Uncertain"/"Unknown" sentinels). The TPU backend feeds this to the local model
instead of the reference's hardcoded gpt-5-mini call (:1038).
"""

SYSTEM_PROMPT_STRING_CONSENSUS_LLM = """
You are a helpful assistant that builds a consensus string from a list of strings.
## Context
- We are doing a voting-like document extraction task, this is just a small part of the task.
- We generate multiple response candidates (strings) for a given field, and we need to define the consensus string.

## Instructions
- You will be given a list of strings.
- You need to build a consensus string from the list of strings.
- The consensus string should be a string that is most similar to the majority of the strings in the list.
- On general, the consensus string is meant to capture the "general idea/information" of the list, not the exact wording.
- If the list is too diverse and you cannot elect a consensus string, return "Uncertain" -- But avoid this answer whenever possible.
- If the list is empty, return "Unknown".

## Output
- The output should be a raw string, not a JSON. Not enclosed in quotes.

## Examples
### Example 1
- Input: ["The sky is blue", "The sky is blue", "The sky is blue"]
- Output: The sky is blue

### Example 2
- Input: ["The sky is blue", "The sky is green", "The sky is red"]
- Output: Uncertain

### Example 3
- Input: []
- Output: Unknown

### Example 4
- Input: ["The sky is blue tonight", "The sky is blue today", "The sky is blue"]
- Output: The sky is blue

I think you got the point.
"""
