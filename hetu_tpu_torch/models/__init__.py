"""Models of the port: GPT-2 decode, BERT pretraining, Wide & Deep CTR."""
from .gpt2 import GPT2Config, gpt2_decode_graph
from .bert import (BertConfig, bert_model, bert_pooler, bert_pretrain_graph,
                   synthetic_mlm_batch)
from .common import masked_lm_loss, merge_heads, split_heads
from .ctr import synthetic_criteo, synthetic_criteo_skewed, wdl_criteo
